"""Mixed-pairing integrators (H1/ND/RT/L2): analytic-integral validation.

Reference analog: the mixed integrator family of fem/bilininteg.hpp:784-2121
(MixedVectorGradient/Curl, VectorFEDivergence, weak divergence, mixed mass)
as exercised by ex24 and the joule miniapp.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fe_vector_simplex import (
    NDSimplexSpace,
    RTSimplexSpace,
)
from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO, RTSpaceHO
from cardiac_ablation_ecm2.fem.fespace import FESpace, L2FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2.ops.mixed_vecfe import (
    mixed_scalar_curl,
    mixed_scalar_mass,
    mixed_vector_curl,
    mixed_vector_gradient,
    mixed_vector_mass,
    mixed_vector_weak_divergence,
    mixed_weak_curl,
    vectorfe_divergence,
)
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)
from tests.test_fespace import permute_vertices


def _proj_vec(space, fn, nq1d):
    """L2 projection into an ND/RT space (exact for in-space fields)."""
    from cardiac_ablation_ecm2.ops.mixed_vecfe import _kind

    build = build_nd_operator if _kind(space) == "nd" else build_rt_operator
    op = build(space, mass_coeff=1.0, nq1d=nq1d)
    b = vecfe_linear_form(op, fn)
    d = op.diagonal()
    x, info = cg(op.mult, b, M=lambda r: r / d, rel_tol=1e-14, max_iter=6000)
    assert bool(info.converged)
    return x


def _integral(gf, vals):
    return float(jnp.sum(gf.wdet * jnp.asarray(vals)))


CASES_3D = [
    ("tet", lambda: (lambda m: (NDSimplexSpace(m, 2), RTSimplexSpace(m, 2)))(
        permute_vertices(make_cartesian_3d_tet(2, 2, 2), 3))),
    ("hex", lambda: (lambda m: (NDSpaceHO(m, 2), RTSpaceHO(m, 2)))(
        permute_vertices(make_cartesian_3d(2, 2, 2), 4))),
]


@pytest.mark.parametrize("name,make", CASES_3D, ids=[c[0] for c in CASES_3D])
def test_vector_gradient_3d(name, make):
    """(∇u, v) for u ∈ H1₂, v ∈ ND₂ equals the analytic integral."""
    nd, _ = make()
    mesh = nd.mesh
    h1 = FESpace(mesh, 2)
    nq1d = 4

    def u(x):
        return x[..., 0] ** 2 + 2 * x[..., 1] * x[..., 2] - x[..., 2]

    def gradu(x):
        return np.stack([2 * x[..., 0], 2 * x[..., 2],
                         2 * x[..., 1] - 1.0], axis=-1)

    def v(x):
        return np.stack([0.3 + x[..., 1], -0.7 + x[..., 2],
                         1.1 - x[..., 0]], axis=-1)

    G = mixed_vector_gradient(h1, nd, nq1d=nq1d)
    xu = project(h1, u)
    xv = _proj_vec(nd, v, nq1d)
    lhs = float(xv @ G.mult(xu))
    gf, _, _ = _vec_tables_of(G, nd, nq1d)
    xq = np.asarray(gf.x)
    rhs = _integral(gf, np.sum(gradu(xq) * v(xq), axis=-1))
    assert np.isclose(lhs, rhs, rtol=1e-10), (lhs, rhs)


def _vec_tables_of(op, space, nq1d):
    """Recreate gf for integral evaluation (same rule as the operator)."""
    from cardiac_ablation_ecm2.ops.mixed_vecfe import _vec_tables

    return _vec_tables(space, nq1d, None)


@pytest.mark.parametrize("name,make", CASES_3D, ids=[c[0] for c in CASES_3D])
def test_vector_curl_3d(name, make):
    """(curl E, v) for E ∈ ND₂, v ∈ RT₂ equals the analytic integral."""
    nd, rt = make()
    nq1d = 4

    def E(x):
        return np.stack([x[..., 1], x[..., 2], x[..., 0]], axis=-1)

    curlE = np.array([-1.0, -1.0, -1.0])

    def v(x):
        return np.stack([0.5 - x[..., 2], 1.0 + x[..., 0],
                         -0.25 + x[..., 1]], axis=-1)

    C = mixed_vector_curl(nd, rt, nq1d=nq1d)
    xe = _proj_vec(nd, E, nq1d)
    xv = _proj_vec(rt, v, nq1d)
    lhs = float(xv @ C.mult(xe))
    gf, _, _ = _vec_tables_of(C, nd, nq1d)
    xq = np.asarray(gf.x)
    rhs = _integral(gf, np.sum(curlE * v(xq), axis=-1))
    assert np.isclose(lhs, rhs, rtol=1e-10), (lhs, rhs)
    # weak curl is the exact transpose pairing: (u, curl v) RT→ND
    W = mixed_weak_curl(rt, nd, nq1d=nq1d)
    lhs_w = float(xe @ W.mult(xv))
    assert np.isclose(lhs_w, lhs, rtol=1e-10), (lhs_w, lhs)


@pytest.mark.parametrize("name,make", CASES_3D, ids=[c[0] for c in CASES_3D])
def test_mixed_vector_mass_3d(name, make):
    """(u, v) across ND₂ × RT₂ equals ∫ u·v."""
    nd, rt = make()
    nq1d = 4

    def u(x):
        return np.stack([1.0 + x[..., 2], x[..., 0] - 2.0,
                         x[..., 1]], axis=-1)

    def v(x):
        return np.stack([x[..., 1], 0.5 + 0 * x[..., 0], -x[..., 2]],
                        axis=-1)

    M = mixed_vector_mass(nd, rt, nq1d=nq1d)
    xu = _proj_vec(nd, u, nq1d)
    xv = _proj_vec(rt, v, nq1d)
    lhs = float(xv @ M.mult(xu))
    gf, _, _ = _vec_tables_of(M, nd, nq1d)
    xq = np.asarray(gf.x)
    rhs = _integral(gf, np.sum(u(xq) * v(xq), axis=-1))
    assert np.isclose(lhs, rhs, rtol=1e-10), (lhs, rhs)


def test_weak_divergence_is_neg_transpose():
    """−(u, ∇v) is exactly the negative transpose of (∇u, v)."""
    mesh = permute_vertices(make_cartesian_2d_tri(3, 3), 2)
    h1 = FESpace(mesh, 2)
    nd = NDSimplexSpace(mesh, 2)
    G = mixed_vector_gradient(h1, nd, nq1d=4)
    W = mixed_vector_weak_divergence(nd, h1, nq1d=4)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(W.ndof_trial))
    y = jnp.asarray(rng.standard_normal(W.ndof_test))
    assert np.allclose(np.asarray(W.mult(x)),
                       -np.asarray(G.mult_t(x)), atol=1e-12)
    assert np.allclose(np.asarray(W.mult_t(y)),
                       -np.asarray(G.mult(y)), atol=1e-12)


def test_scalar_curl_2d():
    """(curl u, q) in 2D: ND₂ × L2₁ on a permuted tri mesh."""
    mesh = permute_vertices(make_cartesian_2d_tri(3, 3), 5)
    nd = NDSimplexSpace(mesh, 2)
    l2 = L2FESpace(mesh, 1)
    nq1d = 4

    def u(x):
        return np.stack([0.2 + 2 * x[..., 1], 1.0 - x[..., 0]], axis=-1)

    curlu = -3.0                       # ∂x v − ∂y u

    C = mixed_scalar_curl(nd, l2, nq1d=nq1d)
    xu = _proj_vec(nd, u, nq1d)
    ones = jnp.ones(l2.ndof_scalar)
    lhs = float(ones @ C.mult(xu))     # (curl u, 1) = ∫ curl u
    gf, _, _ = _vec_tables_of(C, nd, nq1d)
    rhs = _integral(gf, curlu * np.ones(gf.wdet.shape))
    assert np.isclose(lhs, rhs, rtol=1e-10), (lhs, rhs)


@pytest.mark.parametrize(
    "mk",
    [lambda: (RTSimplexSpace(permute_vertices(
        make_cartesian_2d_tri(3, 3), 1), 2), 4),
     lambda: (RTSpaceHO(make_cartesian_2d(3, 3), 2), 4)],
    ids=["tri-rt2", "quad-rt2"])
def test_vectorfe_divergence(mk):
    """(div u, q): RT₂ × L2₁; (div u, 1) = boundary flux of the projected
    field (divergence theorem at the discrete level)."""
    rt_space, nq1d = mk()
    mesh = rt_space.mesh
    l2 = L2FESpace(mesh, 1)

    def u(x):
        return np.stack([x[..., 0] * 2 + x[..., 1], x[..., 1]], axis=-1)

    divu = 3.0

    D = vectorfe_divergence(rt_space, l2, nq1d=nq1d)
    xu = _proj_vec(rt_space, u, nq1d)
    ones = jnp.ones(l2.ndof_scalar)
    lhs = float(ones @ D.mult(xu))
    gf, _, _ = _vec_tables_of(D, rt_space, nq1d)
    rhs = _integral(gf, divu * np.ones(gf.wdet.shape))
    assert np.isclose(lhs, rhs, rtol=1e-10), (lhs, rhs)


def test_divergence_matches_rt0_block_op():
    """General vectorfe_divergence reduces to the RT0×P0 fast path used by
    the Darcy block system (ops.block.mixed_divergence)."""
    from cardiac_ablation_ecm2.fem.fe_vector import RTSpace
    from cardiac_ablation_ecm2.ops.block import mixed_divergence

    mesh = make_cartesian_2d(3, 3)
    rt0 = RTSpace(mesh)
    l2 = L2FESpace(mesh, 0)
    B, _ = mixed_divergence(rt0, l2, nq1d=3)
    D = vectorfe_divergence(rt0, l2, nq1d=3)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(rt0.ndof))
    assert np.allclose(np.asarray(B(x)), np.asarray(D.mult(x)), atol=1e-12)


def test_mixed_scalar_mass_h1_l2():
    """(u, q) H1₂ × L2₁: pairing with q=1 gives ∫ u."""
    mesh = permute_vertices(make_cartesian_2d_tri(3, 3), 9)
    h1 = FESpace(mesh, 2)
    l2 = L2FESpace(mesh, 1)
    nq1d = 4

    def u(x):
        return x[..., 0] ** 2 + x[..., 1]

    M = mixed_scalar_mass(h1, l2, nq1d=nq1d)
    xu = project(h1, u)
    ones = jnp.ones(l2.ndof_scalar)
    lhs = float(ones @ M.mult(xu))
    # exact: ∫ (x² + y) over unit square = 1/3 + 1/2
    assert np.isclose(lhs, 1.0 / 3 + 0.5, rtol=1e-10), lhs


def test_assemble_matrix_matches_mult():
    mesh = permute_vertices(make_cartesian_3d_tet(2, 2, 2), 8)
    h1 = FESpace(mesh, 2)
    nd = NDSimplexSpace(mesh, 2)
    G = mixed_vector_gradient(h1, nd, nq1d=4)
    A = G.assemble_matrix()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(G.ndof_trial)
    y = rng.standard_normal(G.ndof_test)
    assert np.allclose(A @ x, np.asarray(G.mult(jnp.asarray(x))), atol=1e-11)
    assert np.allclose(A.T @ y, np.asarray(G.mult_t(jnp.asarray(y))),
                       atol=1e-11)
