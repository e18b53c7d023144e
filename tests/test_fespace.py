"""FESpace dof enumeration: counts, continuity, orientation invariance.

The projection test is the strongest check: nodal-project a degree-p
polynomial and verify exactness at quadrature points.  This fails if any
shared dof is numbered inconsistently between neighboring elements (edge/face
orientation bugs) — the reference's analog is the H1 continuity implied by
tests/unit/fem/test_fespace.cpp + doftrans tests.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project, values_at_quad, l2_error
from cardiac_ablation_ecm2.fem.build import geom_factors_for, restriction_for
from cardiac_ablation_ecm2.mesh import (
    Mesh,
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)


def permute_vertices(mesh, seed=0):
    """Relabel vertices with a random permutation — stresses all edge/face
    orientation canonicalization paths."""
    rng = np.random.default_rng(seed)
    nv = mesh.nv
    perm = rng.permutation(nv)          # old id -> new id
    inv = np.empty(nv, dtype=np.int64)
    inv[perm] = np.arange(nv)
    return Mesh(
        geom=mesh.geom,
        vertices=mesh.vertices[inv],
        elements=perm[mesh.elements],
        attributes=mesh.attributes,
        boundary=perm[mesh.boundary],
        bdr_attributes=mesh.bdr_attributes,
    )


def perturb(mesh, amount=0.15, seed=1):
    """Randomly move interior vertices (non-affine elements)."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices.copy()
    lo, hi = v.min(axis=0), v.max(axis=0)
    interior = np.all((v > lo + 1e-12) & (v < hi - 1e-12), axis=1)
    v[interior] += amount * (rng.random(v[interior].shape) - 0.5) * 0.5
    m2 = Mesh(
        geom=mesh.geom,
        vertices=v,
        elements=mesh.elements,
        attributes=mesh.attributes,
        boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes,
    )
    return m2


CASES = [
    (make_cartesian_2d(3, 3), "quad"),
    (make_cartesian_3d(2, 2, 2), "hex"),
    (make_cartesian_2d_tri(3, 3), "tri"),
    (make_cartesian_3d_tet(2, 2, 2), "tet"),
]


@pytest.mark.parametrize("p", [1, 2, 3])
def test_dof_counts_cartesian(p):
    nx = ny = 3
    m = make_cartesian_2d(nx, ny)
    fes = FESpace(m, p)
    assert fes.ndof_scalar == (p * nx + 1) * (p * ny + 1)
    m3 = make_cartesian_3d(2, 2, 2)
    fes3 = FESpace(m3, p)
    assert fes3.ndof_scalar == (2 * p + 1) ** 3


@pytest.mark.parametrize("mesh,name", CASES, ids=[c[1] for c in CASES])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_projection_exact(mesh, name, p):
    mesh = permute_vertices(mesh, seed=hash(name) % 100)
    fes = FESpace(mesh, p)
    dim = mesh.dim

    def f(x):
        # polynomial of total degree ≤ p in all variables
        out = np.asarray(x[..., 0]) ** p
        if p >= 2 and dim >= 2:
            out = out + np.asarray(x[..., 0]) * np.asarray(x[..., 1]) ** (p - 1)
        if p >= 3 and dim >= 3:
            out = out + np.asarray(x[..., 2]) ** (p - 1) * np.asarray(x[..., 0])
        return out

    u = project(fes, f)
    gf = geom_factors_for(fes)
    uq = values_at_quad(fes, u)
    exact = f(np.asarray(gf.x))
    assert np.allclose(np.asarray(uq), exact, atol=1e-10), (
        name, p, np.abs(np.asarray(uq) - exact).max()
    )


@pytest.mark.parametrize("p", [2, 3])
def test_projection_exact_perturbed_hex(p):
    """Perturbed (non-affine) hexes with permuted vertex ids: isoparametric
    projection of a degree-1 function must stay exact (Q1 ⊂ Qp span)."""
    mesh = perturb(permute_vertices(make_cartesian_3d(3, 3, 3), 5))
    fes = FESpace(mesh, p)

    def f(x):
        x = np.asarray(x)
        return 2.0 * x[..., 0] - 0.7 * x[..., 1] + 0.3 * x[..., 2] + 1.0

    u = project(fes, f)
    gf = geom_factors_for(fes)
    uq = values_at_quad(fes, u)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_essential_dofs_2d():
    m = make_cartesian_2d(3, 3)
    fes = FESpace(m, 2)
    ess_all = fes.essential_dofs()
    # boundary dofs of order-2 space on 3x3 grid: perimeter of 7x7 node grid
    assert len(ess_all) == 4 * 7 - 4  # perimeter of the 7x7 node grid
    # simpler invariant: every boundary dof coordinate lies on the boundary
    xy = fes.dof_coords[ess_all]
    on_b = (
        np.isclose(xy[:, 0], 0) | np.isclose(xy[:, 0], 1)
        | np.isclose(xy[:, 1], 0) | np.isclose(xy[:, 1], 1)
    )
    assert on_b.all()
    # single-attribute selection
    ess_bottom = fes.essential_dofs([1])
    xyb = fes.dof_coords[ess_bottom]
    assert np.allclose(xyb[:, 1], 0.0)
    assert len(ess_bottom) == 2 * 3 + 1


def test_restriction_transpose_is_adjoint():
    m = make_cartesian_3d(2, 2, 2)
    fes = FESpace(m, 3)
    R = restriction_for(fes)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.random(fes.ndof_scalar))
    v = jnp.asarray(rng.random((m.ne, fes.nd_elem)))
    lhs = float(jnp.vdot(R.mult(u), v))
    rhs = float(jnp.vdot(u, R.mult_transpose(v)))
    assert np.isclose(lhs, rhs, rtol=1e-12)
