"""Serendipity quad elements S_2/S_3 (H1Ser_FECollection analog,
fem/fe_coll.hpp:347)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.serendipity import (
    SerendipityFESpace,
    serendipity_basis_matrices,
    serendipity_nodes,
    serendipity_operator,
)
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d


@pytest.mark.parametrize("p", [2, 3])
def test_nodal_basis_partition(p):
    nodes = serendipity_nodes(p)
    B, G = serendipity_basis_matrices(p, nodes)
    assert np.allclose(B, np.eye(len(nodes)), atol=1e-10)   # nodal
    rng = np.random.default_rng(0)
    pts = rng.random((20, 2))
    B2, _ = serendipity_basis_matrices(p, pts)
    assert np.allclose(B2.sum(axis=1), 1.0, atol=1e-10)     # PoU


@pytest.mark.parametrize("p", [2, 3])
def test_dof_count_and_energy_identity(p):
    mesh = make_cartesian_2d(4, 3)
    sp = SerendipityFESpace(mesh, p)
    nedge = (4 * 3 * 2 + 4 + 3)
    assert sp.ndof == mesh.nv + nedge * (p - 1)
    mult, diag = serendipity_operator(sp)
    X = sp.dof_coords()
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 0] * X[:, 1])
    # ∫|∇u|² over unit square, u = x²+xy: ∇u = (2x+y, x):
    # ∫(2x+y)² = 4/3+1+1/3; ∫x² = 1/3 → total 3.0
    energy = float(u @ mult(u))
    assert np.isclose(energy, 3.0, rtol=1e-10), energy


def test_linear_annihilation_and_symmetry():
    mesh = make_cartesian_2d(3, 4)
    sp = SerendipityFESpace(mesh, 3)
    mult, _ = serendipity_operator(sp)
    X = sp.dof_coords()
    lin = jnp.asarray(0.5 + X[:, 0] - 3 * X[:, 1])
    r = np.asarray(mult(lin))
    ess = sp.essential_dofs()
    mask = np.ones(sp.ndof, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-10
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(sp.ndof))
    b = jnp.asarray(rng.standard_normal(sp.ndof))
    assert np.isclose(float(a @ mult(b)), float(b @ mult(a)), rtol=1e-12)


@pytest.mark.parametrize("p", [2, 3])
def test_poisson_convergence(p):
    """L2 convergence at order p+1 on −Δu = f, u = sin πx sin πy."""
    exact = lambda x: np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def solve(n):
        mesh = make_cartesian_2d(n, n)
        sp = SerendipityFESpace(mesh, p)
        mult, diag = serendipity_operator(sp)
        mmult, _ = serendipity_operator(sp, diffusion_coeff=0.0,
                                        mass_coeff=1.0)
        X = sp.dof_coords()
        u_ex = jnp.asarray(exact(X))
        ess = jnp.asarray(sp.essential_dofs())
        m = jnp.ones(sp.ndof).at[ess].set(0.0)
        # RHS via operator identity on the interpolant (quadrature-exact
        # enough to see the convergence order)
        b = (2 * np.pi ** 2) * mmult(u_ex)
        A = lambda v: mult(v * m) * m + v * (1 - m)
        d = diag() * m + (1 - m)
        u, info = cg(A, b * m, M=lambda r: r / d, rel_tol=1e-12,
                     max_iter=4000)
        # nodal max error as the metric (superconvergent but monotone)
        return float(jnp.abs(u - u_ex).max())

    e1, e2 = solve(4), solve(8)
    rate = np.log2(e1 / e2)
    assert rate > p + 0.5, (e1, e2, rate)
