"""Lowest-order ND/RT on pyramid meshes.

Reference analog: ND_FuentesPyramidElement (fe/fe_nd.hpp:427) /
RT_FuentesPyramidElement (fe/fe_rt.hpp:346) at order 1.  ND0 is the
Gradinaru–Hiptmair rational Whitney pyramid (covariant degenerate-hex
pullback); RT0 is the direct constant-trace rational construction
(fe_vector.py pyramid branches).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d_pyramid
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)


def _project(op, fn):
    b = vecfe_linear_form(op, fn)
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=5000)
    assert info.converged
    return x


def _qvals(op, x):
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    return jnp.einsum("eqnc,en->eqc", Bq, x[op.gather] * op.signs)


def test_nd0_pyramid_constant():
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    c = np.array([0.3, -1.1, 0.7])
    op = build_nd_operator(NDSpace(mesh), mass_coeff=1.0, nq1d=4)
    x = _project(op, lambda p: np.broadcast_to(c, p.shape))
    assert np.abs(np.asarray(_qvals(op, x)) - c).max() < 1e-8


def test_nd0_pyramid_constant_curl_free():
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    nd = NDSpace(mesh)
    opm = build_nd_operator(nd, mass_coeff=1.0, nq1d=4)
    opc = build_nd_operator(nd, mass_coeff=None, curlcurl_coeff=1.0, nq1d=4)
    c = np.array([1.0, -0.5, 0.25])
    x = _project(opm, lambda p: np.broadcast_to(c, p.shape))
    curl_e = float(jnp.vdot(x, opc.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert curl_e < 1e-12 * mass_e


def test_nd0_pyramid_projection_convergence():
    errs = []
    for n in (3, 6):
        mesh = make_cartesian_3d_pyramid(n, n, n)
        op = build_nd_operator(NDSpace(mesh), mass_coeff=1.0, nq1d=4)

        def E(p):
            return np.stack([np.sin(np.pi * p[..., 1]),
                             np.sin(np.pi * p[..., 2]),
                             np.sin(np.pi * p[..., 0])], axis=-1)

        x = _project(op, E)
        v = _qvals(op, x)
        ex = jnp.asarray(E(np.asarray(op.gf.x)))
        errs.append(float(jnp.sqrt(jnp.sum(
            op.gf.wdet * jnp.sum((v - ex) ** 2, -1)))))
    assert np.log2(errs[0] / errs[1]) > 0.7, errs


def test_nd0_pyramid_curlcurl_patch_solve():
    """curl curl E + E = f reproduces a constant exact solution (constants
    are curl-free and in the space — tangential conformity across the
    mixed tri faces is exercised by the assembled solve)."""
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    op = build_nd_operator(NDSpace(mesh), mass_coeff=1.0,
                           curlcurl_coeff=1.0, nq1d=4)
    c = np.array([0.6, -0.2, 1.1])
    b = vecfe_linear_form(op, lambda p: np.broadcast_to(c, p.shape))
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=5000)
    assert info.converged
    assert np.abs(np.asarray(_qvals(op, x)) - c).max() < 1e-8


def test_rt0_pyramid_constant():
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    c = np.array([0.4, -0.9, 1.3])
    op = build_rt_operator(RTSpace(mesh), mass_coeff=1.0, nq1d=4)
    x = _project(op, lambda p: np.broadcast_to(c, p.shape))
    assert np.abs(np.asarray(_qvals(op, x)) - c).max() < 1e-8


def test_rt0_pyramid_linear_div_exact():
    """u = (x,y,z) ∈ RT0(pyramid): div-div energy = 9·|Ω| exactly."""
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    rt = RTSpace(mesh)
    opm = build_rt_operator(rt, mass_coeff=1.0, nq1d=4)
    opd = build_rt_operator(rt, mass_coeff=None, divdiv_coeff=1.0, nq1d=4)
    x = _project(opm, lambda p: p)
    div_e = float(jnp.vdot(x, opd.mult(x)))
    assert abs(div_e - 9.0) < 1e-8, div_e


def test_rt0_pyramid_constant_div_free():
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    rt = RTSpace(mesh)
    opm = build_rt_operator(rt, mass_coeff=1.0, nq1d=4)
    opd = build_rt_operator(rt, mass_coeff=None, divdiv_coeff=1.0, nq1d=4)
    c = np.array([1.0, 0.5, -0.25])
    x = _project(opm, lambda p: np.broadcast_to(c, p.shape))
    div_e = float(jnp.vdot(x, opd.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert div_e < 1e-12 * mass_e


def test_rt0_pyramid_projection_convergence():
    errs = []
    for n in (2, 4):
        mesh = make_cartesian_3d_pyramid(n, n, n)
        op = build_rt_operator(RTSpace(mesh), mass_coeff=1.0, nq1d=4)

        def F(p):
            return np.stack([np.sin(np.pi * p[..., 1]),
                             np.cos(np.pi * p[..., 2]),
                             np.sin(np.pi * p[..., 0])], axis=-1)

        x = _project(op, F)
        v = _qvals(op, x)
        ex = jnp.asarray(F(np.asarray(op.gf.x)))
        errs.append(float(jnp.sqrt(jnp.sum(
            op.gf.wdet * jnp.sum((v - ex) ** 2, -1)))))
    assert np.log2(errs[0] / errs[1]) > 0.7, errs
