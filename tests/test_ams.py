"""AMS / ADS auxiliary-space preconditioners (linalg/ams.py).

Reference analogs: HypreAMS (linalg/hypre.hpp:1984) / HypreADS (:2061).
The defining property tested here: Jacobi-PCG iteration counts on
curl-curl / div-div systems grow unboundedly under refinement, while the
auxiliary-space-preconditioned counts stay (near-)bounded."""

import numpy as np
import pytest

import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.linalg.ams import (
    _nd_pi,
    _rt_pi,
    _transpose_of,
    make_ads,
    make_ams,
)
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    discrete_gradient,
)


def _hier(nref):
    meshes = [make_cartesian_3d(2, 2, 2)]
    for _ in range(nref):
        meshes.append(meshes[-1].uniform_refinement())
    return meshes


def _masked(op, ess, n):
    mask = np.ones(n)
    mask[ess] = 0.0
    m = jnp.asarray(mask)

    def A(v):
        return op.mult(v * m) * m + v * (1 - m)

    return A, op.diagonal() * m + (1 - m), m


def test_gradient_space_identity():
    """Gᵀ(curlcurl_α + mass_β)G == β·(H1 stiffness) exactly — the algebraic
    backbone of AMS (∇H1₁ ⊂ ND₁ and curl∘grad = 0)."""
    mesh = make_cartesian_3d(3, 3, 3)
    nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
    beta = 2.0
    op = build_nd_operator(nd, mass_coeff=beta, curlcurl_coeff=1.0)
    G = discrete_gradient(h1, nd)
    GT = _transpose_of(G, h1.ndof_scalar, jnp.float64)
    L = BilinearForm(h1).add_domain_integrator(
        "diffusion", coeff=beta).assemble()
    u = jnp.asarray(np.random.default_rng(0).standard_normal(h1.ndof_scalar))
    lhs, rhs = GT(op.mult(G(u))), L.mult(u)
    assert float(jnp.abs(lhs - rhs).max()) < 1e-12 * float(jnp.abs(rhs).max())


@pytest.mark.parametrize("maker", [make_cartesian_3d, make_cartesian_3d_tet])
def test_nd_pi_reproduces_constants(maker):
    mesh = maker(3, 3, 3)
    h1 = FESpace(mesh, 1)
    nd = NDSpace(mesh)
    from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form

    c = np.array([0.3, -0.7, 1.1])
    M = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=None)
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    x, _ = cg(M.mult, b, M=lambda r: r / M.diagonal(), rel_tol=1e-12,
              max_iter=3000)
    pi = _nd_pi(mesh, h1, jnp.float64)
    ones = jnp.ones(h1.ndof_scalar)
    xpi = sum(float(c[d]) * pi(ones, d) for d in range(3))
    assert float(jnp.abs(x - xpi).max()) < 1e-8


@pytest.mark.parametrize("maker", [make_cartesian_3d, make_cartesian_3d_tet])
def test_rt_pi_reproduces_constants(maker):
    mesh = maker(3, 3, 3)
    h1 = FESpace(mesh, 1)
    rt = RTSpace(mesh)
    from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form

    c = np.array([0.3, -0.7, 1.1])
    M = build_rt_operator(rt, mass_coeff=1.0, divdiv_coeff=None)
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    x, _ = cg(M.mult, b, M=lambda r: r / M.diagonal(), rel_tol=1e-12,
              max_iter=3000)
    pi = _rt_pi(mesh, rt, h1, jnp.float64)
    ones = jnp.ones(h1.ndof_scalar)
    xpi = sum(float(c[d]) * pi(ones, d) for d in range(3))
    assert float(jnp.abs(x - xpi).max()) < 1e-8


def test_ams_bounded_iterations():
    """The VERDICT r2 'done' criterion: iteration-count-vs-refinement table
    bounded for AMS where Jacobi blows up (ex3-class curl-curl + mass)."""
    meshes = _hier(3)
    rng = np.random.default_rng(1)
    jac, ams_it = [], []
    for nref in (1, 2, 3):
        hier = meshes[:nref + 1]
        mesh = hier[-1]
        nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
        op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0)
        A, dg, m = _masked(op, nd.essential_dofs(None), nd.ndof)
        b = jnp.asarray(rng.standard_normal(nd.ndof)) * m
        _, i1 = cg(A, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=8000)
        bdr = sorted(set(mesh.bdr_attributes.tolist()))
        ams = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=hier)
        x2, i2 = cg(A, b, M=ams, rel_tol=1e-10, max_iter=8000)
        assert float(jnp.linalg.norm(A(x2) - b)) < 1e-8 * float(
            jnp.linalg.norm(b))
        jac.append(int(i1.iterations))
        ams_it.append(int(i2.iterations))
    # Jacobi roughly doubles per refinement; AMS stays near-flat
    assert jac[-1] > 2 * ams_it[-1]
    assert ams_it[-1] < 1.6 * ams_it[0]
    assert jac[-1] > 1.8 * jac[-2]


def test_ads_bounded_iterations():
    meshes = _hier(3)
    rng = np.random.default_rng(2)
    jac, ads_it = [], []
    for nref in (1, 2, 3):
        hier = meshes[:nref + 1]
        mesh = hier[-1]
        rt, nd, h1 = RTSpace(mesh), NDSpace(mesh), FESpace(mesh, 1)
        op = build_rt_operator(rt, mass_coeff=1.0, divdiv_coeff=1.0)
        A, dg, m = _masked(op, rt.essential_dofs(None), rt.ndof)
        b = jnp.asarray(rng.standard_normal(rt.ndof)) * m
        _, i1 = cg(A, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=8000)
        bdr = sorted(set(mesh.bdr_attributes.tolist()))
        ads = make_ads(rt, nd, h1, A, dg, ess_bdr=bdr, meshes=hier)
        x2, i2 = cg(A, b, M=ads, rel_tol=1e-10, max_iter=8000)
        assert float(jnp.linalg.norm(A(x2) - b)) < 1e-8 * float(
            jnp.linalg.norm(b))
        jac.append(int(i1.iterations))
        ads_it.append(int(i2.iterations))
    assert jac[-1] > 4 * ads_it[-1]
    assert jac[-1] > 1.8 * jac[-2]


def test_ams_on_tets():
    """AMS on an unstructured-style tet mesh (Whitney elements)."""
    mesh = make_cartesian_3d_tet(4, 4, 4)
    nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0)
    A, dg, m = _masked(op, nd.essential_dofs(None), nd.ndof)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(nd.ndof)) * m
    _, i1 = cg(A, b, M=lambda r: r / dg, rel_tol=1e-10, max_iter=8000)
    bdr = sorted(set(mesh.bdr_attributes.tolist()))
    ams = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=None)
    x2, i2 = cg(A, b, M=ams, rel_tol=1e-10, max_iter=8000)
    assert float(jnp.linalg.norm(A(x2) - b)) < 1e-8 * float(jnp.linalg.norm(b))
    assert int(i2.iterations) < int(i1.iterations)
