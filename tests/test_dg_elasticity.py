"""DG (SIPG) elasticity — ex17 analog (DGElasticityIntegrator,
fem/bilininteg.hpp:3018)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops.dg_elasticity import DGElasticity


def test_symmetry():
    fes = L2FESpace(make_cartesian_2d(3, 3), 2)
    A = DGElasticity(fes, lam=1.5, mu=0.8)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(A.ndof))
    y = jnp.asarray(rng.standard_normal(A.ndof))
    s1, s2 = float(x @ A.mult(y)), float(y @ A.mult(x))
    assert abs(s1 - s2) < 1e-10 * abs(s1)


@pytest.mark.parametrize("p", [1, 2])
def test_linear_displacement_exact(p):
    """Weak-Dirichlet solve with a linear boundary displacement recovers
    the linear field exactly (consistency of all face terms)."""
    mesh = make_cartesian_2d(4, 4)
    fes = L2FESpace(mesh, p)
    A = DGElasticity(fes, lam=1.5, mu=1.0)

    def g(xq):
        out = np.zeros(xq.shape[:-1] + (2,))
        out[..., 0] = 0.3 * xq[..., 0] - 0.2 * xq[..., 1] + 0.1
        out[..., 1] = 0.5 * xq[..., 1] + 0.4 * xq[..., 0]
        return out

    b = A.dirichlet_rhs(g)
    u, info = cg(A.mult, b, M=lambda r: r / A.diagonal(),
                 rel_tol=1e-13, max_iter=6000)
    assert bool(info.converged)
    db, gf = basis_for(fes), geom_factors_for(fes)
    uu = u.reshape(mesh.ne, fes.nd_elem, 2)
    gq = g(np.asarray(gf.x))
    for c in range(2):
        uq = eval_values(db, uu[..., c])
        assert float(jnp.abs(uq - gq[..., c]).max()) < 1e-9


def test_h_convergence_vs_smooth_solution():
    """Manufactured u = (sin πx sin πy, 0): L2 error drops at ≥ O(h²)
    for p = 1 (body force f = −div σ(u) computed analytically)."""
    lam, mu = 1.0, 1.0

    def exact(xq):
        out = np.zeros(xq.shape[:-1] + (2,))
        out[..., 0] = np.sin(np.pi * xq[..., 0]) * np.sin(np.pi * xq[..., 1])
        return out

    def body(xq):
        # u = (s, 0), s = sin πx sin πy:
        # σ = λ (∂x s) I + μ [[2∂x s, ∂y s], [∂y s, 0]]
        # f = −div σ = −(λ+2μ) ∂xx s − μ ∂yy s  (x-comp),
        #     −(λ+μ) ∂xy s                      (y-comp)
        x, y = xq[..., 0], xq[..., 1]
        s_xx = -np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * y)
        s_yy = s_xx
        s_xy = np.pi ** 2 * np.cos(np.pi * x) * np.cos(np.pi * y)
        out = np.zeros(xq.shape[:-1] + (2,))
        out[..., 0] = -(lam + 2 * mu) * s_xx - mu * s_yy
        out[..., 1] = -(lam + mu) * s_xy
        return out

    def solve(n):
        mesh = make_cartesian_2d(n, n)
        fes = L2FESpace(mesh, 1)
        A = DGElasticity(fes, lam=lam, mu=mu)
        db, gf = basis_for(fes), geom_factors_for(fes)
        # body-force RHS per component
        fq = body(np.asarray(gf.x))
        from cardiac_ablation_ecm2.fem.quadinterp import eval_values_t

        b = jnp.stack(
            [eval_values_t(db, gf.wdet * jnp.asarray(fq[..., c]))
             for c in range(2)], axis=-1).reshape(-1)
        b = b + A.dirichlet_rhs(lambda xq: np.zeros(xq.shape[:-1] + (2,)))
        u, info = cg(A.mult, b, M=lambda r: r / A.diagonal(),
                     rel_tol=1e-12, max_iter=8000)
        assert bool(info.converged)
        uu = u.reshape(mesh.ne, fes.nd_elem, 2)
        eq = exact(np.asarray(gf.x))
        err2 = 0.0
        for c in range(2):
            uq = eval_values(db, uu[..., c])
            err2 += float(jnp.sum(gf.wdet * (uq - eq[..., c]) ** 2))
        return np.sqrt(err2)

    e1, e2 = solve(4), solve(8)
    rate = np.log2(e1 / e2)
    assert rate > 1.6, (e1, e2, rate)
