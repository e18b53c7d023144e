"""Arbitrary-order pyramid elements (fem/pyramid_p.py — the order-p
rational product pyramid; fe_pyramid.cpp H1 analog at p >= 4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import (
    basis_for,
    geom_factors_for,
    restriction_for,
)
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.fem.pyramid_p import (
    pyramid_nodes,
    pyramid_num_dofs,
    pyramid_p_basis_matrices,
)
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d_pyramid
from cardiac_ablation_ecm2.ops import BilinearForm


@pytest.mark.parametrize("p", [4, 5, 6])
def test_span_dimension_and_unisolvence(p):
    """Independent-multiset count == canonical pyramid dof count, and the
    nodal set is unisolvent (finite Vandermonde condition)."""
    from math import comb

    assert pyramid_num_dofs(p) == comb(p + 4, 4) - comb(p + 2, 4)
    N = pyramid_nodes(p)
    assert len(N) == pyramid_num_dofs(p)
    B, _ = pyramid_p_basis_matrices(p, N)
    assert np.abs(B - np.eye(len(N))).max() < 1e-7  # nodal (cond-limited)


@pytest.mark.parametrize("p", [4, 5])
def test_polynomial_containment_and_pou(p):
    rng = np.random.default_rng(0)
    pc = rng.random((300, 3))
    z = pc[:, 2] * 0.98
    pts = np.stack([(1 - z) * pc[:, 0], (1 - z) * pc[:, 1], z], axis=1)
    B, G = pyramid_p_basis_matrices(p, pts)
    assert np.abs(B.sum(1) - 1).max() < 1e-9            # PoU
    # P_p containment: interpolate every total-degree<=p monomial exactly
    N = pyramid_nodes(p)
    for a in range(p + 1):
        for b in range(p + 1 - a):
            c = p - a - b
            f = lambda q: q[:, 0] ** a * q[:, 1] ** b * q[:, 2] ** c
            co = f(N)
            assert np.abs(B @ co - f(pts)).max() < 1e-8
    # gradient consistency on one monomial
    f = lambda q: q[:, 0] ** 2 * q[:, 2] ** (p - 2)
    co = f(N)
    gx = 2 * pts[:, 0] * pts[:, 2] ** (p - 2)
    gz = (p - 2) * pts[:, 0] ** 2 * pts[:, 2] ** (p - 3)
    g = np.einsum("pnc,n->pc", G, co)
    assert np.abs(g[:, 0] - gx).max() < 1e-7
    assert np.abs(g[:, 2] - gz).max() < 1e-7


def test_trace_conformity_p4():
    """Off-face basis traces vanish identically; quad-face trace lies in
    Q_p and tri-face trace in P_p — the H1-conformity conditions against
    order-p hex and tet neighbors (shared-node unisolvence)."""
    p = 4
    N = pyramid_nodes(p)
    rng = np.random.default_rng(1)
    # quad base z=0
    uv = rng.random((150, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], np.zeros(len(uv))], axis=1)
    B, _ = pyramid_p_basis_matrices(p, pts)
    onf = np.abs(N[:, 2]) < 1e-12
    assert np.abs(B[:, ~onf]).max() == 0.0
    M = np.stack([uv[:, 0] ** a * uv[:, 1] ** b
                  for a in range(p + 1) for b in range(p + 1)], axis=1)
    r = np.abs(B - M @ np.linalg.lstsq(M, B, rcond=None)[0]).max()
    assert r < 1e-9
    # tri face y=0 (verts 0,1,4)
    ab = rng.random((150, 2))
    ab = ab[ab.sum(1) < 1]
    pts = np.stack([ab[:, 0], np.zeros(len(ab)), ab[:, 1]], axis=1)
    B, _ = pyramid_p_basis_matrices(p, pts)
    onf = np.abs(N[:, 1]) < 1e-12
    assert np.abs(B[:, ~onf]).max() == 0.0
    M = np.stack([ab[:, 0] ** a * ab[:, 1] ** b
                  for a in range(p + 1) for b in range(p + 1 - a)], axis=1)
    r = np.abs(B - M @ np.linalg.lstsq(M, B, rcond=None)[0]).max()
    assert r < 1e-10


def test_fespace_p4_projection_and_operator():
    """FESpace wiring: degree-4 fields reproduce exactly on the 6-pyramid
    cube mesh; the assembled diffusion operator is symmetric and
    annihilates linears on interior dofs."""
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    fes = FESpace(mesh, 4)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** 4 + x[..., 1] * x[..., 2] ** 3

    u = project(fes, f)
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(u))
    gf = geom_factors_for(fes)
    assert np.abs(np.asarray(uq) - f(np.asarray(gf.x))).max() < 5e-6

    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    X = fes.dof_coords
    lin = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(lin))
    mask = np.ones(fes.ndof_scalar, bool)
    mask[fes.essential_dofs(None)] = False
    assert np.abs(r[mask]).max() < 5e-6
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.standard_normal(fes.ndof_scalar).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(fes.ndof_scalar).astype(np.float32))
    assert np.isclose(float(a @ A.mult(b)), float(b @ A.mult(a)), rtol=1e-5)


@pytest.mark.parametrize("seed", [3, 7])
def test_vertex_permutation_projection_exactness_p5(seed):
    """Randomly relabel the global vertex numbering (geometry unchanged) so
    edge-flip / face-orientation canonicalization in _pyramid_p_keys is hit
    on every branch, then check degree-5 projection exactness — conformity
    + orientation maps must agree across all permuted element interfaces."""
    from cardiac_ablation_ecm2.mesh.mesh import Mesh

    base = make_cartesian_3d_pyramid(2, 2, 2)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(base.nv)           # old index -> new index
    verts = np.empty_like(base.vertices)
    verts[perm] = base.vertices
    mesh = Mesh(base.geom, verts, perm[base.elements], base.attributes,
                perm[base.boundary], base.bdr_attributes)

    fes = FESpace(mesh, 5)

    def f(x):
        x = np.asarray(x)
        return (x[..., 0] ** 5 - 2 * x[..., 1] ** 2 * x[..., 2] ** 3
                + x[..., 0] * x[..., 1] * x[..., 2])

    u = project(fes, f)
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(u))
    gf = geom_factors_for(fes)
    assert np.abs(np.asarray(uq) - f(np.asarray(gf.x))).max() < 2e-5


def test_poisson_galerkin_exactness_p4():
    """-Δu = f with u_ex = x²y² + z⁴ ∈ span: the Galerkin solution IS the
    interpolant, so CG recovers it to solver tolerance."""
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    fes = FESpace(mesh, 4)
    X = fes.dof_coords

    def u_fn(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 * x[..., 1] ** 2 + x[..., 2] ** 4

    def f_fn(x):
        x = np.asarray(x)
        return -(2 * x[..., 1] ** 2 + 2 * x[..., 0] ** 2
                 + 12 * x[..., 2] ** 2)

    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    b = domain_lf(fes, f_fn)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    u_ex = jnp.asarray(u_fn(X))
    ess = fes.essential_dofs(None)
    m = np.ones(fes.ndof_scalar, np.float32)
    m[ess] = 0.0
    m = jnp.asarray(m)
    rhs = (b - A.mult(u_ex * (1 - m))) * m

    def Aop(x):
        return A.mult(x * m) * m + x * (1 - m)

    u, info = cg(Aop, rhs, rel_tol=1e-7, max_iter=4000)
    assert bool(info.converged)
    u = u * m + u_ex * (1 - m)
    assert float(jnp.abs(u - u_ex).max()) < 2e-4
