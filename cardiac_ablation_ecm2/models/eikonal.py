"""Eikonal/distance-function approximation via p-Laplacian continuation.

Reference analog: ``examples/ex40.cpp`` (eikonal by proximal Galerkin).
Here the classical variational route: the p-torsion minimizer

    min E_p(u) = ∫ |∇u|^p / p − u,    u = 0 on ∂Ω,

converges to the distance-to-boundary function as p → ∞.  Design:
only the ENERGY is written; ``jax.grad`` gives the p-Laplacian residual
and ``jax.linearize`` inside Newton the consistent tangent — continuation
in p with warm starts, every solve jit-compiled."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad
from ..linalg.newton import newton
from ..ops.linearform import domain_lf


@dataclasses.dataclass(eq=False)
class EikonalSolver:
    mesh: object
    order: int = 2
    p_schedule: Sequence[float] = (2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)
    eps: float = 1e-12
    rel_tol: float = 1e-9
    dtype: object = None

    def __post_init__(self):
        self.fes = FESpace(self.mesh, self.order)
        self.gf = geom_factors_for(self.fes, dtype=self.dtype)
        self.db = basis_for(self.fes, dtype=self.dtype)
        self.R = restriction_for(self.fes)
        self._adj = adjugate(self.gf.jac)
        ess = self.fes.essential_dofs()
        self.mask = jnp.ones(self.fes.ndof_scalar).at[
            jnp.asarray(ess)].set(0.0)
        self.b1 = domain_lf(self.fes,
                            lambda x: 1.0 + 0 * np.asarray(x)[..., 0])

    def _phys_grad(self, u):
        g = eval_grad(self.db, self.R.mult(u))
        return jnp.einsum("eqab,eqa->eqb", self._adj,
                          g) / self.gf.det[..., None]

    def energy(self, u, p):
        g2 = jnp.sum(self._phys_grad(u) ** 2, axis=-1)
        return (jnp.sum(self.gf.wdet * (g2 + self.eps) ** (p / 2) / p)
                - self.b1 @ u)

    def solve(self):
        """Distance-function approximation (L-vector) after the p
        continuation."""
        m = self.mask
        u = jnp.zeros(self.fes.ndof_scalar)
        for p in self.p_schedule:
            def res(v, p=p):
                r = jax.grad(lambda w: self.energy(w, p))(v)
                return r * m + v * (1 - m)

            u, info = newton(res, u, rel_tol=self.rel_tol, max_iter=40,
                             linear_solver="cg", line_search=8)
        return u, info
