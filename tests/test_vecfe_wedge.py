"""Lowest-order ND/RT on wedge (prism) meshes.

Reference analog: ND_WedgeElement (fe/fe_nd.hpp:343, = ND_tri ⊗ H1_seg ⊕
H1_tri ⊗ ND_seg) and RT_WedgeElement (fe/fe_rt.hpp:280) at order 1, with
the edge/face dof + sign orientation machinery shared with every other
geometry (fe_vector.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d_prism
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)


def _shuffle_base(mesh, seed=3):
    """Rotate each wedge's base triangle (cyclic, orientation-preserving):
    same geometry, shuffled local edge/face orientations."""
    rng = np.random.default_rng(seed)
    elems = mesh.elements.copy()
    for e in range(mesh.ne):
        r = int(rng.integers(3))
        lo, hi = elems[e, :3], elems[e, 3:]
        elems[e, :3] = np.roll(lo, r)
        elems[e, 3:] = np.roll(hi, r)
    return type(mesh)(
        geom=mesh.geom, vertices=mesh.vertices, elements=elems,
        attributes=mesh.attributes, boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes)


def _project(op, fn):
    b = vecfe_linear_form(op, fn)
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    assert info.converged
    return x


def _qvals(op, x):
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    return jnp.einsum("eqnc,en->eqc", Bq, x[op.gather] * op.signs)


@pytest.mark.parametrize("shuffled", [False, True])
def test_nd0_wedge_constant(shuffled):
    mesh = make_cartesian_3d_prism(3, 3, 3)
    if shuffled:
        mesh = _shuffle_base(mesh)
    c = np.array([0.3, -1.1, 0.7])
    op = build_nd_operator(NDSpace(mesh), mass_coeff=1.0, nq1d=3)
    x = _project(op, lambda p: np.broadcast_to(c, p.shape))
    assert np.abs(np.asarray(_qvals(op, x)) - c).max() < 1e-8


@pytest.mark.parametrize("shuffled", [False, True])
def test_nd0_wedge_gradient_curl_free(shuffled):
    """∇H1 ⊂ ND0(wedge): the projected gradient has zero curl energy."""
    mesh = make_cartesian_3d_prism(3, 3, 2)
    if shuffled:
        mesh = _shuffle_base(mesh, seed=11)
    nd = NDSpace(mesh)
    opm = build_nd_operator(nd, mass_coeff=1.0, nq1d=3)
    opc = build_nd_operator(nd, mass_coeff=None, curlcurl_coeff=1.0, nq1d=3)

    def gradf(p):
        # ∇((x + 2y − 1)z + x) = (z + 1, 2z, x + 2y − 1): the gradient of a
        # wedge-H1 P1 function — in-plane constants ⊗ {1, z} plus an affine
        # ẑ part, all inside the wedge ND0 span (unlike ∇(xy), whose
        # symmetric (y, x) part the triangle Whitney family lacks)
        return np.stack([p[..., 2] + 1.0, 2.0 * p[..., 2],
                         p[..., 0] + 2.0 * p[..., 1] - 1.0], axis=-1)

    x = _project(opm, gradf)
    curl_e = float(jnp.vdot(x, opc.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert curl_e < 1e-12 * mass_e


def test_nd0_wedge_projection_convergence():
    errs = []
    for n in (3, 6):
        mesh = make_cartesian_3d_prism(n, n, n)
        op = build_nd_operator(NDSpace(mesh), mass_coeff=1.0, nq1d=3)

        def E(p):
            return np.stack([np.sin(np.pi * p[..., 1]),
                             np.sin(np.pi * p[..., 2]),
                             np.sin(np.pi * p[..., 0])], axis=-1)

        x = _project(op, E)
        v = _qvals(op, x)
        ex = jnp.asarray(E(np.asarray(op.gf.x)))
        errs.append(float(jnp.sqrt(jnp.sum(
            op.gf.wdet * jnp.sum((v - ex) ** 2, -1)))))
    assert np.log2(errs[0] / errs[1]) > 0.8, errs


def test_nd0_wedge_curlcurl_solve():
    """Definite Maxwell patch solve: curl curl E + E = f with the exact
    solution in the FE space (E = gradient + constant) is reproduced."""
    mesh = _shuffle_base(make_cartesian_3d_prism(2, 2, 2), seed=5)
    nd = NDSpace(mesh)
    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0, nq1d=3)

    def E(p):
        # gradient field (see test_nd0_wedge_gradient_curl_free) + constant
        return np.stack([p[..., 2] + 1.0, 2.0 * p[..., 2] - 0.5,
                         p[..., 0] + 2.0 * p[..., 1] - 1.0], axis=-1)

    # curl E = 0 → f = E; solve the full (curlcurl + mass) system
    b = vecfe_linear_form(op, E)
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    assert info.converged
    v = np.asarray(_qvals(op, x))
    ex = E(np.asarray(op.gf.x))
    assert np.abs(v - ex).max() < 1e-8


@pytest.mark.parametrize("shuffled", [False, True])
def test_rt0_wedge_constant(shuffled):
    mesh = make_cartesian_3d_prism(3, 3, 3)
    if shuffled:
        mesh = _shuffle_base(mesh, seed=7)
    c = np.array([0.4, -0.9, 1.3])
    op = build_rt_operator(RTSpace(mesh), mass_coeff=1.0, nq1d=3)
    x = _project(op, lambda p: np.broadcast_to(c, p.shape))
    assert np.abs(np.asarray(_qvals(op, x)) - c).max() < 1e-8


def test_rt0_wedge_divfree_kernel():
    """A constant field is div-free; div-div energy vanishes."""
    mesh = make_cartesian_3d_prism(3, 3, 2)
    rt = RTSpace(mesh)
    opm = build_rt_operator(rt, mass_coeff=1.0, nq1d=3)
    opd = build_rt_operator(rt, mass_coeff=None, divdiv_coeff=1.0, nq1d=3)
    c = np.array([1.0, 0.5, -0.25])
    x = _project(opm, lambda p: np.broadcast_to(c, p.shape))
    div_e = float(jnp.vdot(x, opd.mult(x)))
    mass_e = float(jnp.vdot(x, opm.mult(x)))
    assert div_e < 1e-12 * mass_e


def test_rt0_wedge_linear_div_exact():
    """u = (x, y, z) has div ≡ 3: projected field's div-div energy equals
    9·|Ω| (the projection is exact — u ∈ RT0(wedge))."""
    mesh = make_cartesian_3d_prism(2, 2, 2)
    rt = RTSpace(mesh)
    opm = build_rt_operator(rt, mass_coeff=1.0, nq1d=3)
    opd = build_rt_operator(rt, mass_coeff=None, divdiv_coeff=1.0, nq1d=3)
    x = _project(opm, lambda p: p)
    div_e = float(jnp.vdot(x, opd.mult(x)))
    assert abs(div_e - 9.0) < 1e-8, div_e
