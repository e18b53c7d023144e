"""ND_R1D / ND_R2D / RT_R2D restricted-dimension vector elements.

Reference analog: fe/fe_nd.hpp:564-774, fe/fe_rt.hpp:447-609,
fem/fe_coll.hpp:554-672; the solve mirrors examples/ex31.cpp (anisotropic
curl curl E + σ E = f with 3-component E on 1D/2D meshes).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_2d_tri
from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form
from cardiac_ablation_ecm2.ops.vecfe_r import (
    NDR1DSpace,
    NDR2DSpace,
    RTR2DSpace,
    build_nd_r1d_operator,
    build_nd_r2d_operator,
    build_rt_r2d_operator,
)

SIGMA = np.array([[2.0, 0.5, 0.0], [0.5, 2.0, 0.5], [0.0, 0.5, 2.0]])


def _solve_ess(op, b, ess, rel_tol=1e-12):
    """CG with homogeneous essential dofs eliminated by masking."""
    keep = np.ones(op.ndof)
    keep[np.asarray(ess)] = 0.0
    keep = jnp.asarray(keep)

    def A(x):
        return op.mult(x * keep) * keep + x * (1 - keep)

    d = jnp.where(keep > 0, op.diagonal(), 1.0)
    x, info = cg(A, b * keep, M=lambda r: r / d, rel_tol=rel_tol,
                 max_iter=8000)
    assert info.converged
    return x


def _l2_err(op, x, exact_fn):
    """Quadrature L2 error of the 3-component field against ``exact_fn``."""
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = op._pre(x[op.gather])
    vals = jnp.einsum("eqnc,en->eqc", Bq, e)
    ex = jnp.asarray(exact_fn(np.asarray(op.gf.x)))
    d2 = jnp.sum((vals - ex) ** 2, axis=-1)
    return float(jnp.sqrt(jnp.sum(op.gf.wdet * d2)))


# ---------------------------------------------------------------------------
# manufactured anisotropic Maxwell solutions (ex31-class)
# ---------------------------------------------------------------------------


def _E2(x):
    px, py = np.pi * x[..., 0], np.pi * x[..., 1]
    return np.stack(
        [np.sin(py), np.sin(px), np.sin(px) * np.sin(py)], axis=-1)


def _f2(x):
    """curl curl E + σ E for _E2 (hand-derived; ∂/∂z ≡ 0)."""
    px, py = np.pi * x[..., 0], np.pi * x[..., 1]
    cc = np.stack(
        [np.pi**2 * np.sin(py), np.pi**2 * np.sin(px),
         2 * np.pi**2 * np.sin(px) * np.sin(py)], axis=-1)
    return cc + _E2(x) @ SIGMA.T


def _E1(x):
    px = np.pi * x[..., 0]
    return np.stack(
        [np.cos(px), np.sin(px), np.sin(2 * px)], axis=-1)


def _f1(x):
    px = np.pi * x[..., 0]
    cc = np.stack(
        [np.zeros_like(px), np.pi**2 * np.sin(px),
         4 * np.pi**2 * np.sin(2 * px)], axis=-1)
    return cc + _E1(x) @ SIGMA.T


# ---------------------------------------------------------------------------
# ND_R1D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 3])
def test_nd_r1d_convergence(order):
    errs = []
    for n in (8, 16):
        sp = NDR1DSpace(np.linspace(0.0, 1.0, n + 1), order)
        op = build_nd_r1d_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0)
        b = vecfe_linear_form(op, _f1)
        x = _solve_ess(op, b, sp.essential_dofs())
        errs.append(_l2_err(op, x, _E1))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.3, (errs, rate)


def test_nd_r1d_x_in_curl_kernel():
    """E = (g(x), 0, 0) has curl ≡ 0 — the R1D gradient-analog subspace."""
    sp = NDR1DSpace(np.linspace(0.0, 1.0, 9), 2)
    opm = build_nd_r1d_operator(sp, mass_coeff=1.0)
    opc = build_nd_r1d_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)
    b = vecfe_linear_form(
        opm, lambda x: np.stack(
            [x[..., 0] ** 2 - x[..., 0], np.zeros_like(x[..., 0]),
             np.zeros_like(x[..., 0])], axis=-1))
    x, info = cg(opm.mult, b, M=lambda r: r / opm.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    curl_e = float(jnp.vdot(x, opc.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert curl_e < 1e-10 * mass_e


# ---------------------------------------------------------------------------
# ND_R2D (quads and triangles)
# ---------------------------------------------------------------------------


def _mesh2(kind, n):
    return (make_cartesian_2d(n, n) if kind == "quad"
            else make_cartesian_2d_tri(n, n))


@pytest.mark.parametrize("kind", ["quad", "tri"])
@pytest.mark.parametrize("order", [1, 2])
def test_nd_r2d_convergence(kind, order):
    errs = []
    for n in (4, 8):
        sp = NDR2DSpace(_mesh2(kind, n), order)
        op = build_nd_r2d_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0)
        b = vecfe_linear_form(op, _f2)
        x = _solve_ess(op, b, sp.essential_dofs())
        errs.append(_l2_err(op, x, _E2))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.35, (errs, rate)


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_nd_r2d_constant_reproduction(kind):
    """Constants ⊂ ND_R2D: mass projection reproduces (c₁,c₂,c₃) exactly."""
    c = np.array([0.3, -1.1, 0.7])
    sp = NDR2DSpace(_mesh2(kind, 3), 2)
    op = build_nd_r2d_operator(sp, mass_coeff=1.0)
    b = vecfe_linear_form(op, lambda x: np.broadcast_to(c, x.shape[:-1] + (3,)))
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, op._pre(x[op.gather])))
    assert np.abs(vals - c).max() < 1e-7


def test_nd_r2d_gradient_family_curl_free():
    """(∇ψ, 0) and constant ẑ fields are curl-free in R2D semantics."""
    sp = NDR2DSpace(make_cartesian_2d(3, 3), 2)
    opm = build_nd_r2d_operator(sp, mass_coeff=1.0)
    opc = build_nd_r2d_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)

    def gradf(x):
        return np.stack([2 * x[..., 0] * x[..., 1],
                         x[..., 0] ** 2,
                         np.ones_like(x[..., 0])], axis=-1)

    b = vecfe_linear_form(opm, gradf)
    x, _ = cg(opm.mult, b, M=lambda r: r / opm.diagonal(),
              rel_tol=1e-13, max_iter=4000)
    curl_e = float(jnp.vdot(x, opc.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert curl_e < 1e-9 * mass_e


def test_nd_r2d_assembled_symmetry():
    sp = NDR2DSpace(make_cartesian_2d(3, 3), 2)
    op = build_nd_r2d_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0)
    A = op.assemble_matrix().toarray()
    assert np.abs(A - A.T).max() < 1e-10
    w = np.linalg.eigvalsh(A)
    assert w.min() > 0


# ---------------------------------------------------------------------------
# RT_R2D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["quad", "tri"])
def test_rt_r2d_constant_reproduction(kind):
    c = np.array([0.4, -0.9, 1.3])
    sp = RTR2DSpace(_mesh2(kind, 3), 1)
    op = build_rt_r2d_operator(sp, mass_coeff=1.0)
    b = vecfe_linear_form(op, lambda x: np.broadcast_to(c, x.shape[:-1] + (3,)))
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, op._pre(x[op.gather])))
    assert np.abs(vals - c).max() < 1e-7


def test_rt_r2d_divdiv_z_kernel():
    """ẑ-block fields are divergence-free: div-div energy of a pure-ẑ
    projection vanishes."""
    sp = RTR2DSpace(make_cartesian_2d(3, 3), 2)
    opm = build_rt_r2d_operator(sp, mass_coeff=1.0)
    opd = build_rt_r2d_operator(sp, mass_coeff=None, divdiv_coeff=1.0)

    def zfield(x):
        return np.stack([np.zeros_like(x[..., 0]),
                         np.zeros_like(x[..., 0]),
                         x[..., 0] * x[..., 1]], axis=-1)

    b = vecfe_linear_form(opm, zfield)
    x, _ = cg(opm.mult, b, M=lambda r: r / opm.diagonal(),
              rel_tol=1e-13, max_iter=4000)
    div_e = float(jnp.vdot(x, opd.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert div_e < 1e-9 * mass_e
