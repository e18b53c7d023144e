"""Quasi-static hyperelasticity — the "ex10" capability slice, the AD way.

Reference analog: ``HyperelasticNLFIntegrator`` + ``NeoHookeanModel``
(``fem/nonlininteg.hpp:200-351``) driven by ``NewtonSolver``; the reference
hand-codes the first and second variations of the stored-energy density.

Design: we write ONLY the energy functional

    E(u) = Σ_q w·detJ · W(F(u)),   F = I + ∇ₓu

through the PA pipeline; ``jax.grad`` delivers the residual (exact first
variation, including all geometric terms) and ``jax.linearize`` inside
Newton delivers the consistent tangent — the entire nonlinear-integrator
kernel family of the reference collapses to ~40 lines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad
from ..linalg.newton import newton
from ..ops.linearform import boundary_lf_vector
from ..utils.config import index_t, real_t


def neo_hookean_W(F, mu: float, kappa: float):
    """Compressible neo-Hookean stored energy (NeoHookeanModel analog):
    W = μ/2 (J^{-2/d}·I₁ − d) + κ/2 (J−1)²."""
    d = F.shape[-1]
    J = jnp.linalg.det(F)
    I1 = jnp.einsum("...ab,...ab->...", F, F)
    Js = jnp.maximum(J, 1e-8)
    return 0.5 * mu * (Js ** (-2.0 / d) * I1 - d) + 0.5 * kappa * (J - 1.0) ** 2


@dataclasses.dataclass(eq=False)
class HyperelasticProblem:
    """min E(u) subject to u = 0 on fixed_bdr, with a dead surface load."""

    fes: FESpace                     # vector space (vdim == dim)
    mu: float = 1.0
    kappa: float = 10.0
    fixed_bdr: Sequence[int] = (1,)
    force_bdr: Sequence[int] = (2,)
    force: Optional[np.ndarray] = None
    dtype: object = None

    def __post_init__(self):
        fes = self.fes
        dim = fes.mesh.dim
        assert fes.vdim == dim
        self.restr = restriction_for(fes)
        self.db = basis_for(fes, dtype=self.dtype)
        self.gf = geom_factors_for(fes, dtype=self.dtype)
        self.Ainv = adjugate(self.gf.jac) / self.gf.det[..., None, None]
        ess_s = fes.essential_dofs(self.fixed_bdr)
        self.ess = jnp.asarray(
            np.concatenate([ess_s + c * fes.ndof_scalar for c in range(dim)]),
            index_t(),
        )
        if self.force is None:
            f = np.zeros(dim)
            f[-1] = -0.05
            self.force = f
        self.b = boundary_lf_vector(
            fes, self.force, bdr_marker=self.force_bdr, dtype=self.dtype
        )
        self.dim = dim
        # fixed Jacobi preconditioner from the small-strain (linearized)
        # elasticity diagonal — spectrally close to the consistent tangent
        from ..ops.bilinearform import BilinearForm

        lam_eff = self.kappa - 2.0 * self.mu / dim
        dlin = (
            BilinearForm(fes)
            .add_domain_integrator("elasticity", coeff=(lam_eff, self.mu))
            .assemble(self.dtype)
            .diagonal()
        )
        dlin = dlin.at[self.ess].set(1.0)
        self._prec_inv = 1.0 / dlin

    # -- energy through the PA pipeline --------------------------------
    def deformation_gradient(self, u_flat):
        fes = self.fes
        ul = u_flat.reshape(self.dim, fes.ndof_scalar).T
        e = self.restr.mult(ul)                       # (ne, nd, dim)
        g = eval_grad(self.db, e)                     # (ne, nq, dref, dim)
        # ∇ₓu[a,c] = Σ_r Jinv[r,a] g[r,c]
        H = jnp.einsum("eqra,eqrc->eqac", self.Ainv, g)
        I = jnp.eye(self.dim, dtype=H.dtype)
        return I + H

    def energy(self, u_flat):
        F = self.deformation_gradient(u_flat)
        W = neo_hookean_W(F, self.mu, self.kappa)
        return jnp.sum(self.gf.wdet * W) - jnp.vdot(self.b, u_flat)

    def residual(self, u_flat):
        r = jax.grad(self.energy)(u_flat)
        r = r.at[self.ess].set(0.0)
        return r + jnp.zeros_like(r).at[self.ess].set(u_flat[self.ess])

    def solve(self, rel_tol=1e-9, max_iter=30, linear_max_iter=800):
        u0 = jnp.zeros(self.fes.ndof, dtype=real_t(self.dtype))
        inv = self._prec_inv
        u, info = newton(
            self.residual, u0, rel_tol=rel_tol, max_iter=max_iter,
            linear_rel_tol=1e-8, linear_max_iter=linear_max_iter,
            line_search=12, precond=lambda u: (lambda r: inv * r),
        )
        return u, info

    def displacement(self, u_flat) -> np.ndarray:
        return np.asarray(u_flat).reshape(self.dim, self.fes.ndof_scalar).T
