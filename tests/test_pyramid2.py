"""Order-2 pyramid elements (14-node rational pyramid; the higher-order
pyramid gap of fem/fe/fe_pyramid)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.pyramid2 import (
    PYRAMID_P2_NODES,
    PyramidP2Space,
    pyramid_p2_basis_matrices,
    pyramid_p2_operator,
)
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d_pyramid


def test_nodal_basis_and_p2_reproduction():
    B, _ = pyramid_p2_basis_matrices(PYRAMID_P2_NODES)
    assert np.allclose(B, np.eye(14), atol=1e-9)
    rng = np.random.default_rng(0)
    pts = rng.random((60, 3)) * np.array([1, 1, 0.95])
    pts[:, :2] *= (1 - pts[:, 2:3])
    Bp, Gp = pyramid_p2_basis_matrices(pts)
    assert np.abs(Bp.sum(1) - 1).max() < 1e-12          # PoU
    # full P2 reproduction (values and gradients)
    for f, g in [
        (lambda q: q[:, 0] ** 2,
         lambda q: np.stack([2 * q[:, 0], 0 * q[:, 0], 0 * q[:, 0]], 1)),
        (lambda q: q[:, 0] * q[:, 2],
         lambda q: np.stack([q[:, 2], 0 * q[:, 0], q[:, 0]], 1)),
        (lambda q: q[:, 2] ** 2,
         lambda q: np.stack([0 * q[:, 0], 0 * q[:, 0], 2 * q[:, 2]], 1)),
    ]:
        co = np.linalg.solve(np.eye(14), f(PYRAMID_P2_NODES))
        assert np.abs(Bp @ co - f(pts)).max() < 1e-10
        assert np.abs(np.einsum("pnc,n->pc", Gp, co) - g(pts)).max() < 1e-9


def test_conformity_and_quadratic_energy():
    """Linear annihilation through shared tri/quad faces + exact quadratic
    energy on the 6-pyramid-per-cube mesh."""
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    sp = PyramidP2Space(mesh)
    mult, _ = pyramid_p2_operator(sp, nq1d=5)
    X = sp.dof_coords()
    lin = jnp.asarray(1.0 + 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(mult(lin))
    ess = sp.essential_dofs()
    mask = np.ones(sp.ndof, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-10
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 1] ** 2 + X[:, 2] ** 2)
    assert np.isclose(float(u @ mult(u)), 4.0, rtol=1e-10)
    # symmetry
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(sp.ndof))
    b = jnp.asarray(rng.standard_normal(sp.ndof))
    assert np.isclose(float(a @ mult(b)), float(b @ mult(a)), rtol=1e-12)


def test_poisson_third_order_convergence():
    def solve(n):
        mesh = make_cartesian_3d_pyramid(n, n, n)
        sp = PyramidP2Space(mesh)
        mult, diag = pyramid_p2_operator(sp, nq1d=5)
        mm, _ = pyramid_p2_operator(sp, diffusion_coeff=0.0,
                                    mass_coeff=1.0, nq1d=5)
        X = sp.dof_coords()
        ex = lambda x: np.prod(np.sin(np.pi * x), axis=-1)
        u_ex = jnp.asarray(ex(X))
        ess = jnp.asarray(sp.essential_dofs())
        m = jnp.ones(sp.ndof).at[ess].set(0.0)
        b = 3 * np.pi ** 2 * mm(u_ex)
        A = lambda v: mult(v * m) * m + v * (1 - m)
        d = diag() * m + (1 - m)
        u, info = cg(A, b * m, M=lambda r: r / d, rel_tol=1e-12,
                     max_iter=5000)
        assert bool(info.converged)
        return float(jnp.abs(u - u_ex).max())

    e1, e2 = solve(2), solve(4)
    assert np.log2(e1 / e2) > 2.7, (e1, e2)
