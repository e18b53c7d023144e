"""Newton + jax.linearize Jacobians: algebraic and PDE-level (nonlinear
diffusion through the full PA pipeline — the dFEM/AD replacement story)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for, restriction_for
from cardiac_ablation_ecm2.fem.gridfunction import l2_error
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.newton import newton
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops import diffusion as dmod
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def test_newton_algebraic():
    A = jnp.asarray(np.diag([1.0, 2.0, 3.0]))

    def F(x):
        return A @ x + 0.1 * x**3 - jnp.asarray([1.0, 2.0, 3.0])

    x, info = newton(F, jnp.zeros(3), rel_tol=1e-12)
    assert bool(info.converged)
    assert np.allclose(np.asarray(F(x)), 0.0, atol=1e-10)


def test_newton_nonlinear_diffusion():
    """−∇·((1+u²)∇u) = f, u=0 on ∂Ω, manufactured u* = sin(πx)sin(πy)."""
    mesh = make_cartesian_2d(12, 12)
    fes = FESpace(mesh, 2)
    restr = restriction_for(fes)
    db = basis_for(fes)
    gf = geom_factors_for(fes)
    ess = jnp.asarray(fes.essential_dofs())

    def u_star(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    # f = −∇·((1+u²)∇u) for u = u*: compute symbolically via sympy-free form
    # ∇·((1+u²)∇u) = (1+u²)Δu + 2u|∇u|²
    def f_rhs(x):
        x = np.asarray(x)
        s, c = np.sin, np.cos
        pi = np.pi
        u = s(pi * x[..., 0]) * s(pi * x[..., 1])
        lap = -2 * pi**2 * u
        gx = pi * c(pi * x[..., 0]) * s(pi * x[..., 1])
        gy = pi * s(pi * x[..., 0]) * c(pi * x[..., 1])
        return -((1 + u**2) * lap + 2 * u * (gx**2 + gy**2))

    b = domain_lf(fes, f_rhs)

    def residual(u):
        uz = u.at[ess].set(0.0)
        uq = eval_values(db, restr.mult(uz))
        qd = dmod.setup(gf, 1.0 + uq**2)
        r = restr.mult_transpose(dmod.apply(db, qd, restr.mult(uz))) - b
        return r.at[ess].set(u[ess])

    u, info = newton(
        residual, jnp.zeros(fes.ndof), rel_tol=1e-11,
        linear_rel_tol=1e-10, linear_max_iter=800,
    )
    assert bool(info.converged), (int(info.iterations), float(info.final_norm))
    assert int(info.iterations) <= 8
    err = float(l2_error(fes, u, u_star))
    assert err < 5e-4, err
