"""3D mixed-geometry meshes: hex region + pyramid glue + tet region
(transition-element meshing, mesh/pyramid.hpp; SURVEY §7 hard-part 5 3D)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.geometry import Geometry
from cardiac_ablation_ecm2.fem.mixed import (
    MixedFESpace,
    MixedPAOperator,
    make_mixed_cube,
    mixed_domain_lf,
)
from cardiac_ablation_ecm2.linalg.solvers import cg


def test_mesh_integrity():
    mm = make_mixed_cube(2)
    geoms = [g for g, _, _ in mm.blocks]
    assert Geometry.CUBE in geoms and Geometry.PYRAMID in geoms \
        and Geometry.TETRAHEDRON in geoms
    fes = MixedFESpace(mm, 1)
    vol = sum(float(jnp.sum(gf.wdet)) for gf in fes.gfs)
    assert np.isclose(vol, 1.0, atol=1e-10)
    # all element volumes positive (orientation correct in every block)
    for gf in fes.gfs:
        assert float(jnp.min(gf.det)) > 0


def test_conforming_linear_exactness():
    mm = make_mixed_cube(2)
    fes = MixedFESpace(mm, 1)
    A = MixedPAOperator(fes, diffusion_coeff=1.0)
    X = fes.dof_coords
    u = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(u))
    ess = fes.essential_dofs()
    mask = np.ones(fes.ndof, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-10
    # symmetry across the hex/pyramid/tet blocks
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(fes.ndof))
    b = jnp.asarray(rng.standard_normal(fes.ndof))
    assert np.isclose(float(a @ A.mult(b)), float(b @ A.mult(a)),
                      rtol=1e-12)


def _solve(n):
    exact = lambda x: np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)
    mm = make_mixed_cube(n)
    fes = MixedFESpace(mm, 1)
    A = MixedPAOperator(fes, diffusion_coeff=1.0)
    b = mixed_domain_lf(
        fes, lambda x: 3 * np.pi ** 2 * np.prod(np.sin(np.pi * x),
                                                axis=-1))
    ess = fes.essential_dofs()
    m = jnp.ones(fes.ndof).at[jnp.asarray(ess)].set(0.0)
    Ac = lambda v: A.mult(v * m) * m + v * (1 - m)
    d = A.diagonal() * m + (1 - m)
    u, info = cg(Ac, b * m, M=lambda r: r / d, rel_tol=1e-11,
                 max_iter=4000)
    assert bool(info.converged)
    # L2 error by block quadrature
    err2 = 0.0
    for gf, db, R in zip(fes.gfs, fes.dbs, fes.restrictions):
        from cardiac_ablation_ecm2.fem.quadinterp import eval_values

        uq = eval_values(db, R.mult(u))
        eq = jnp.asarray(exact(np.asarray(gf.x)))
        err2 += float(jnp.sum(gf.wdet * (uq - eq) ** 2))
    return np.sqrt(err2)


def test_poisson_h_convergence():
    e1, e2 = _solve(2), _solve(4)
    rate = np.log2(e1 / e2)
    assert rate > 1.7, (e1, e2, rate)   # O(h²) for P1/Q1


def test_order2_conformity_and_quadratic_energy():
    """Order-2 mixed cube: the 14-node pyramid's Q2 base / P2 tri traces
    conform exactly against hex Q2 and tet P2 neighbors."""
    mm = make_mixed_cube(2)
    fes = MixedFESpace(mm, 2)
    A = MixedPAOperator(fes, diffusion_coeff=1.0)
    X = fes.dof_coords
    lin = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(lin))
    ess = fes.essential_dofs()
    mask = np.ones(fes.ndof, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-10
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 1] ** 2 + X[:, 2] ** 2)
    assert np.isclose(float(u @ A.mult(u)), 4.0, rtol=1e-12)


def test_order2_poisson_convergence():
    """O(h³)-ish nodal convergence on the order-2 mixed cube."""
    exact = lambda x: np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)

    def solve(n):
        mm = make_mixed_cube(n)
        fes = MixedFESpace(mm, 2)
        A = MixedPAOperator(fes, diffusion_coeff=1.0)
        M = MixedPAOperator(fes, mass_coeff=1.0)
        X = fes.dof_coords
        u_ex = jnp.asarray(exact(X))
        ess = fes.essential_dofs()
        m = jnp.ones(fes.ndof).at[jnp.asarray(ess)].set(0.0)
        b = 3 * np.pi ** 2 * M.mult(u_ex)
        Ac = lambda v: A.mult(v * m) * m + v * (1 - m)
        d = A.diagonal() * m + (1 - m)
        u, info = cg(Ac, b * m, M=lambda r: r / d, rel_tol=1e-11,
                     max_iter=5000)
        assert bool(info.converged)
        return float(jnp.abs(u - u_ex).max())

    e1, e2 = solve(2), solve(4)
    assert np.log2(e1 / e2) > 2.5, (e1, e2)


def test_order3_conformity_and_cubic_energy():
    """Order-3 mixed cube: the 30-node pyramid's Q3 base / P3 tri traces
    (fem/pyramid3.py) conform exactly against hex Q3 and tet P3 neighbors.
    Reference analog: order-p Fuentes-Keith pyramids, fem/fe/fe_pyramid.cpp."""
    mm = make_mixed_cube(2)
    fes = MixedFESpace(mm, 3)
    A = MixedPAOperator(fes, diffusion_coeff=1.0)
    X = fes.dof_coords
    lin = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(lin))
    ess = fes.essential_dofs()
    mask = np.ones(fes.ndof, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-9
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 1] ** 2 + X[:, 2] ** 2)
    assert np.isclose(float(u @ A.mult(u)), 4.0, rtol=1e-11)
    # cubic: u = x³ → ∫|∇u|² = ∫ 9x⁴ = 9/5, exact only if every block
    # (incl. the rational pyramid space ⊇ P₃) represents cubics
    u3 = jnp.asarray(X[:, 0] ** 3)
    assert np.isclose(float(u3 @ A.mult(u3)), 1.8, rtol=1e-11)


def test_order3_poisson_convergence():
    """O(h⁴) L2-ish nodal convergence on the order-3 mixed cube."""
    exact = lambda x: np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)

    def solve(n):
        mm = make_mixed_cube(n)
        fes = MixedFESpace(mm, 3)
        A = MixedPAOperator(fes, diffusion_coeff=1.0)
        M = MixedPAOperator(fes, mass_coeff=1.0)
        X = fes.dof_coords
        u_ex = jnp.asarray(exact(X))
        ess = fes.essential_dofs()
        m = jnp.ones(fes.ndof).at[jnp.asarray(ess)].set(0.0)
        b = 3 * np.pi ** 2 * M.mult(u_ex)
        Ac = lambda v: A.mult(v * m) * m + v * (1 - m)
        d = A.diagonal() * m + (1 - m)
        u, info = cg(Ac, b * m, M=lambda r: r / d, rel_tol=1e-12,
                     max_iter=6000)
        assert bool(info.converged)
        return float(jnp.abs(u - u_ex).max())

    e1, e2 = solve(2), solve(4)
    # nodal max-error rate between n=2 and n=4 is pre-asymptotic
    # (measured 3.26); design L2 rate is 4
    assert np.log2(e1 / e2) > 3.0, (e1, e2)


def test_order2_hex_wedge_conformity():
    """Hex + wedge order-2 blocks conform through the generic entity keys
    (wedge quad-face traces are GLL⊗GLL, matching hex Q2 faces)."""
    from cardiac_ablation_ecm2.fem.mixed import MixedMesh
    from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d

    h = make_cartesian_3d(2, 2, 2)
    cent = h.vertices[h.elements].mean(axis=1)
    left = cent[:, 0] < 0.5
    hexes = h.elements[left]
    wedges = []
    for t in h.elements[~left]:
        wedges.append([t[0], t[1], t[2], t[4], t[5], t[6]])
        wedges.append([t[0], t[2], t[3], t[4], t[6], t[7]])
    mm = MixedMesh(
        vertices=h.vertices,
        blocks=((Geometry.CUBE, hexes, np.ones(len(hexes), np.int64)),
                (Geometry.PRISM, np.array(wedges, dtype=np.int64),
                 np.ones(len(wedges), np.int64))),
        boundary=np.zeros((0, 2), np.int64),
        bdr_attributes=np.zeros(0, np.int64),
    )
    fes = MixedFESpace(mm, 2)
    vol = sum(float(jnp.sum(gf.wdet)) for gf in fes.gfs)
    assert np.isclose(vol, 1.0, atol=1e-12)
    A = MixedPAOperator(fes, diffusion_coeff=1.0)
    X = fes.dof_coords
    lin = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(lin))
    on_surf = (np.abs(X) < 1e-12).any(1) | (np.abs(X - 1) < 1e-12).any(1)
    assert np.abs(r[~on_surf]).max() < 1e-12
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 1] ** 2 + X[:, 2] ** 2)
    assert np.isclose(float(u @ A.mult(u)), 4.0, rtol=1e-12)
