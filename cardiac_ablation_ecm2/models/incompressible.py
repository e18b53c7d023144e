"""Incompressible hyperelasticity — the ex19 capability slice.

Reference analog: ``examples/ex19.cpp`` — incompressible neo-Hookean
block system solved by a custom block Newton with hand-coded Jacobian
blocks.  Design: write only the Lagrangian

    L(u, p) = ∫ W_dev(F) + p (J − 1),    F = I + ∇u

on a Taylor–Hood pair (vector H1_p × H1_{p−1}); ``jax.grad`` gives the
coupled residual, ``jax.linearize`` inside Newton the exact tangent
saddle operator, solved with GMRES (indefinite)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.quadinterp import eval_grad, eval_values
from ..fem.geom_factors import adjugate
from ..linalg.newton import newton
from ..utils.config import real_t


def dev_neo_hookean_W(F, mu: float):
    """Deviatoric neo-Hookean energy μ/2 (J^{-2/d} I₁ − d)."""
    d = F.shape[-1]
    J = jnp.linalg.det(F)
    I1 = jnp.einsum("...ab,...ab->...", F, F)
    Js = jnp.maximum(J, 1e-8)
    return 0.5 * mu * (Js ** (-2.0 / d) * I1 - d)


@dataclasses.dataclass(eq=False)
class IncompressibleHyperelastic:
    """Stationary point of L(u, p) with per-component essential BCs."""

    mesh: object
    order: int = 2
    mu: float = 1.0
    #: list of (component, bdr_attrs, value) roller/stretch constraints
    ess: Sequence = ()
    dtype: object = None

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        rt = real_t(self.dtype)
        self.sfes = FESpace(mesh, self.order)           # scalar components
        self.pfes = FESpace(mesh, max(self.order - 1, 1))
        self.dim = dim
        ns = self.sfes.ndof_scalar
        self.ns = ns
        self.nu = dim * ns
        self.np_ = self.pfes.ndof_scalar
        nq1d = self.order + 2                   # one shared rule: J−1 is
        self.gf = geom_factors_for(self.sfes, nq1d, dtype=self.dtype)
        self.db_u = basis_for(self.sfes, nq1d, dtype=self.dtype)
        self.db_p = basis_for(self.pfes, nq1d, dtype=self.dtype)
        self.Ru = restriction_for(self.sfes)
        self.Rp = restriction_for(self.pfes)
        self._adj = adjugate(self.gf.jac)

        mask = np.ones(self.nu + self.np_)
        vals = np.zeros(self.nu + self.np_)
        for (comp, attrs, value) in self.ess:
            sd = self.sfes.essential_dofs(attrs)
            mask[sd + comp * ns] = 0.0
            vals[sd + comp * ns] = value
        self.mask = jnp.asarray(mask, rt)
        self.vals = jnp.asarray(vals, rt)

    def _grad_u(self, u_flat):
        ns = self.ns
        cols = []
        for c in range(self.dim):
            ghat = eval_grad(self.db_u,
                             self.Ru.mult(u_flat[c * ns:(c + 1) * ns]))
            gphys = jnp.einsum("eqab,eqa->eqb", self._adj,
                               ghat) / self.gf.det[..., None]
            cols.append(gphys)
        return jnp.stack(cols, axis=2)                  # (ne, nq, c, s)

    def lagrangian(self, x):
        u, p = x[: self.nu], x[self.nu:]
        G = self._grad_u(u)                       # (ne, nq, d, d) = ∇ₓu
        F = G + jnp.eye(self.dim, dtype=G.dtype)
        W = dev_neo_hookean_W(F, self.mu)
        pq = eval_values(self.db_p, self.Rp.mult(p))
        J = jnp.linalg.det(F)
        return jnp.sum(self.gf.wdet * (W + pq * (J - 1.0)))

    def residual(self, x):
        r = jax.grad(self.lagrangian)(x)
        return r * self.mask + (x - self.vals) * (1 - self.mask)

    def solve(self, rel_tol=1e-9, max_iter=30, linear_max_iter=2000):
        x0 = self.vals
        x, info = newton(self.residual, x0, rel_tol=rel_tol,
                         max_iter=max_iter, linear_solver="gmres",
                         linear_max_iter=linear_max_iter)
        return x, info

    def deformation_stats(self, x):
        """(min J, max J) over quadrature points."""
        u = x[: self.nu]
        F = self._grad_u(u) + jnp.eye(self.dim)
        J = jnp.linalg.det(F)
        return float(J.min()), float(J.max())
