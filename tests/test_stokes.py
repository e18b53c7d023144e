"""Taylor–Hood Stokes via the H1-pair mixed integrators
(VectorDivergenceIntegrator / GradientIntegrator analogs,
ops/mixed_vecfe.py).

Manufactured polynomial solution u = (y², x²) (div-free, quadratic),
p = x + y − 1 (linear, mean-zero) with f = −Δu + ∇p = (−1, −1):
P2–P1 contains both exactly, so the discrete saddle-point solve must
reproduce them to solver tolerance — simultaneously validating the
divergence block, its adjoint (the gradient block), and the vector
diffusion block."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.krylov_extra import minres
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf_vector
from cardiac_ablation_ecm2.ops.mixed_vecfe import (derivative, gradient,
                                                       vector_divergence)


def test_mixed_h1_pair_adjoint_and_exactness():
    """D = (div u, q) agrees with exact quadrature on polynomials;
    gradient() is the true (∇p, v) form: exact on polynomials and equal to
    −Dᵀ only against velocities with zero normal trace (integration by
    parts — the r3 advisor finding)."""
    mesh = make_cartesian_2d(4, 4)
    V = FESpace(mesh, 2, vdim=2)
    Q = FESpace(mesh, 1)
    ns = V.ndof_scalar
    D = vector_divergence(V, Q)
    G = gradient(Q, V)

    # exactness: p = x + y − 1 → ∇p = (1, 1), so G p = (1, v) ⊕ (1, v)
    Xq = np.asarray(Q.dof_coords)
    p_lin = jnp.asarray(Xq[:, 0] + Xq[:, 1] - 1.0)
    got = np.asarray(G.mult(p_lin))
    want = np.asarray(domain_lf_vector(V, np.array([1.0, 1.0])))
    assert np.allclose(got, want, atol=1e-13)

    # (∇p, u) = −(p, div u) for u with zero boundary trace (no bdry term)
    rng = np.random.default_rng(0)
    ess = V.essential_dofs([1, 2, 3, 4])
    fixed = np.concatenate([ess, ess + ns])
    mask = np.ones(V.ndof)
    mask[fixed] = 0.0
    u = jnp.asarray(rng.standard_normal(V.ndof) * mask)
    q = jnp.asarray(rng.standard_normal(Q.ndof_scalar))
    lhs = float(D.mult(u) @ q)
    rhs = -float(u @ G.mult(q))
    assert abs(lhs - rhs) < 1e-12 * max(abs(lhs), 1.0)

    # u = (x², x·y): div u = 2x + x = 3x; (q_j, 3x) must match exactly
    X = np.asarray(V.dof_coords)
    u_poly = jnp.asarray(np.concatenate([X[:, 0] ** 2, X[:, 0] * X[:, 1]]))
    got = np.asarray(D.mult(u_poly))
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    want = np.asarray(domain_lf(Q, lambda x: 3 * x[..., 0]))
    assert np.allclose(got, want, atol=1e-13)

    # DerivativeIntegrator: (du/dx, v) of u = x² (order-2 trial) is (2x, v)
    S = FESpace(mesh, 2)
    d0 = derivative(S, Q, 0)
    ux = jnp.asarray(np.asarray(S.dof_coords)[:, 0] ** 2)
    got = np.asarray(d0.mult(ux))
    want = np.asarray(domain_lf(Q, lambda x: 2 * x[..., 0]))
    assert np.allclose(got, want, atol=1e-13)


def test_taylor_hood_stokes_reproduces_polynomial():
    mesh = make_cartesian_2d(4, 4)
    V = FESpace(mesh, 2, vdim=2)
    Q = FESpace(mesh, 1)
    nu, nq = V.ndof, Q.ndof_scalar
    ns = V.ndof_scalar

    A = BilinearForm(V).add_domain_integrator("diffusion").assemble()
    D = vector_divergence(V, Q)

    X = np.asarray(V.dof_coords)
    u_ex = np.concatenate([X[:, 1] ** 2, X[:, 0] ** 2])
    Xq = np.asarray(Q.dof_coords)
    p_ex = Xq[:, 0] + Xq[:, 1] - 1.0

    # Dirichlet u = u_ex on the whole boundary
    ess = V.essential_dofs([1, 2, 3, 4])
    fixed = np.concatenate([ess, ess + ns])
    fm = jnp.zeros(nu).at[jnp.asarray(fixed)].set(1.0)
    free = 1.0 - fm
    fv = jnp.asarray(u_ex) * fm

    f = domain_lf_vector(V, np.array([-1.0, -1.0]))
    # pressure gauge: mean-zero via lumped-mass weights
    wq = np.asarray(BilinearForm(Q).add_domain_integrator(
        "mass").assemble_matrix().sum(axis=1)).ravel()
    wq = jnp.asarray(wq / wq.sum())

    # symmetric saddle system with Dirichlet masking and a rank-one mean
    # gauge on p:  [A_bc  −free·Dᵀ; −D·free   w wᵀ] (z) = (rhs)
    def K(z):
        u, p = z[:nu], z[nu:]
        uf = u * free
        Au = A.mult(uf) * free + (u - uf)
        up = Au - D.mult_t(p) * free
        div = -D.mult(uf) + wq * jnp.sum(p * wq)
        return jnp.concatenate([up, div])

    rhs = jnp.concatenate([
        (f - A.mult(fv)) * free + fv,
        D.mult(fv),
    ])
    diagA = A.diagonal() * free + fm
    prec = lambda z: jnp.concatenate([z[:nu] / diagA, z[nu:]])
    z, info = minres(K, rhs, M=prec, rel_tol=1e-12, max_iter=6000)
    assert bool(info.converged)
    u, p = np.asarray(z[:nu]), np.asarray(z[nu:])
    # discrete pressure is defined up to the gauge: shift to mean-zero
    p = p - np.asarray(wq) @ p / np.asarray(wq).sum()

    assert np.abs(u - u_ex).max() < 1e-8, np.abs(u - u_ex).max()
    assert np.abs(p - p_ex).max() < 1e-7, np.abs(p - p_ex).max()
