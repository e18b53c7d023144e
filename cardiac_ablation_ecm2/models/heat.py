"""Nonlinear heat conduction — the "ex16" capability slice.

Reference analog: ``examples/ex16.cpp`` ``ConductionOperator`` (SURVEY.md
§3.4): du/dt = M⁻¹(−K(u)u) with κ(u) = κ₀ + α·u, SDIRK implicit stepping via
``ImplicitSolve``: solve (M + γK(u)) k = −K(u)u, with κ frozen at the stage
base state (same linearization as the reference, ex16.cpp:327-356).

Design: qdata for K(u) is re-computed *inside the jitted step* from the
current solution's Q-vector — no re-assembly machinery, just einsums; the dt
enters as a traced scalar so time-step changes do not retrigger compilation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.quadinterp import eval_values
from ..linalg.solvers import cg
from ..ops import diffusion, mass


@dataclasses.dataclass(eq=False)
class ConductionOperator:
    """TimeDependentOperator for du/dt = M⁻¹(−K(u)u) (ex16.cpp:52)."""

    fes: FESpace
    kappa: float = 0.5
    alpha: float = 0.01
    ess_bdr: object = ()            # boundary attrs with fixed temperature
    rel_tol: float = 1e-10
    max_iter: int = 500
    dtype: object = None

    def __post_init__(self):
        fes = self.fes
        self.restr = restriction_for(fes)
        self.db = basis_for(fes, dtype=self.dtype)
        self.gf = geom_factors_for(fes, dtype=self.dtype)
        self.mass_qd = mass.setup(self.gf)
        self.mass_diag_e = mass.diagonal(self.db, self.mass_qd)
        self.mass_diag = self.restr.mult_transpose(self.mass_diag_e)
        ess = fes.essential_dofs(self.ess_bdr) if self.ess_bdr else \
            np.zeros(0, dtype=np.int32)
        from ..utils.config import index_t, real_t
        self.ess = jnp.asarray(ess, dtype=index_t())
        self.has_ess = len(ess) > 0
        m = np.ones(fes.ndof, dtype=np.float64)
        m[np.asarray(ess)] = 0.0
        self.ess_mask = jnp.asarray(m, real_t(self.dtype))

    def _zero_ess(self, v):
        return v * self.ess_mask if self.has_ess else v

    # -- internals -----------------------------------------------------
    def _kappa_q(self, u):
        """κ(u) = κ₀ + α·u at quadrature points."""
        uq = eval_values(self.db, self.restr.mult(u))
        return self.kappa + self.alpha * uq

    def _K_apply(self, qd, v):
        e = self.restr.mult(v)
        return self.restr.mult_transpose(diffusion.apply(self.db, qd, e))

    def _M_apply(self, v):
        e = self.restr.mult(v)
        return self.restr.mult_transpose(mass.apply(self.db, self.mass_qd, e))

    # -- TimeDependentOperator protocol -------------------------------
    def mult(self, t, u):
        """du/dt = M⁻¹(−K(u)u) via CG on the mass matrix (ex16.cpp:317-325)."""
        qd = diffusion.setup_packed(self.gf, self._kappa_q(u))
        rhs = self._zero_ess(-self._K_apply(qd, u))

        def Mc(v):
            z = self._zero_ess(v)
            return self._zero_ess(self._M_apply(z)) + (v - z)

        diag = self.mass_diag
        if self.has_ess:
            diag = diag * self.ess_mask + (1.0 - self.ess_mask)
        inv = 1.0 / diag
        x, _ = cg(Mc, rhs, M=lambda r: inv * r,
                  rel_tol=self.rel_tol, max_iter=self.max_iter)
        return self._zero_ess(x)

    def implicit_solve(self, gamma, t, u):
        """Solve (M + γ K(u)) k = −K(u) u (ex16.cpp:327-356)."""
        qd = diffusion.setup_packed(self.gf, self._kappa_q(u))

        def T_apply(v):
            z = self._zero_ess(v)
            y = self._M_apply(z) + gamma * self._K_apply(qd, z)
            return self._zero_ess(y) + (v - z)

        rhs = self._zero_ess(-self._K_apply(qd, u))
        kdiag = diffusion.diagonal(self.db, qd)
        diag = self.mass_diag + gamma * self.restr.mult_transpose(kdiag)
        if self.has_ess:
            diag = diag * self.ess_mask + (1.0 - self.ess_mask)
        inv = 1.0 / diag
        k, _ = cg(
            T_apply, rhs, M=lambda r: inv * r,
            rel_tol=self.rel_tol, max_iter=self.max_iter,
        )
        return self._zero_ess(k)


def make_stepper(op: ConductionOperator, solver) -> Callable:
    """Jitted (u, t, dt) -> (u', t') step for a given ODE solver."""

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    return step
