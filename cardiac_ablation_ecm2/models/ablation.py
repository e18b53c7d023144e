"""Coupled RF cardiac ablation: electrostatic Laplace → SAR Joule heating →
Pennes bioheat → Arrhenius lesion (BASELINE.json config 4 — the flagship app).

Reference analog: the coupled-physics architecture of
``miniapps/electromagnetics/joule.cpp`` (potential solve feeding a thermal
transient, joule_solver.hpp:107) specialized to cardiac RF ablation.

Pipeline per simulation:
  1. Solve ∇·(σ∇Φ)=0.  With ``sigma_T`` + ``resolve_every=N`` set, the
     potential is re-solved every N steps with the temperature-dependent
     conductivity σ(T) (warm-started CG — the joule.cpp field/thermal
     coupling loop).
  2. Q_rf = σ|∇Φ|² enters the Pennes RHS.
  3. Implicit SDIRK stepping of T; with ``k_T`` set the thermal
     conductivity k(T) is re-evaluated each step (lagged).
  4. Arrhenius damage integral Ω(t) = ∫ A·exp(−Eₐ/(R·T)) dt accumulated at
     quadrature points; lesion = {Ω ≥ 1} (63% cell death).

The per-step update (bioheat stage solves + damage accumulation) is one
jitted function; see ``step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from ..fem.build import geom_factors_for
from ..fem.gridfunction import values_at_quad
from ..linalg import ode
from ..utils.config import real_t
from . import bioheat, rf_laplace

R_GAS = 8.314462618        # J/(mol K)


def arrhenius_rate(Tq, A: float, Ea: float):
    """A·exp(−Eₐ/(R·T)) at temperatures ``Tq`` [°C], evaluated as one
    exponential of ln A − Eₐ/(R·T): A itself (~1e39 for tissue) overflows
    float32."""
    return jnp.exp(math.log(A) - Ea / (R_GAS * (Tq + 273.15)))


@dataclasses.dataclass(eq=False)
class AblationSim:
    """Coupled simulation state + jitted steppers."""

    mesh: object
    order: int = 2
    # RF
    sigma: float = 0.54                 # S/m
    voltage: float = 30.0               # V
    electrode_bdr: Sequence[int] = (1,)
    ground_bdr: Sequence[int] = (2,)
    # tissue thermal
    rho_c: float = 3.6e6                # J/(m³K)
    k_th: float = 0.54                  # W/(mK)
    w_cb: float = 20000.0               # perfusion ω_b c_b [W/(m³K)]
    T_a: float = 37.0
    q_met: float = 0.0
    body_bdr: Optional[Sequence[int]] = None   # fixed-T boundary
    # Arrhenius (cardiac tissue, Jacques-style parameters)
    arr_A: float = 7.39e39              # 1/s
    arr_Ea: float = 2.577e5             # J/mol
    solver: str = "sdirk33"
    rel_tol: float = 1e-10
    dtype: object = None
    #: (nx, ny, nz) to use the structured Cartesian fast path (large meshes)
    cartesian: object = None
    # -- temperature coupling (joule.cpp-style field re-solve) ----------
    #: σ(T): callable on a (ne, nq) temperature Q-vector [°C] → σ Q-vector.
    #: With ``resolve_every`` > 0 the potential is re-solved with σ(T).
    sigma_T: object = None
    #: k(T): callable on a temperature Q-vector → thermal-conductivity
    #: Q-vector; re-evaluated (lagged at the step start) every step.
    k_T: object = None
    #: re-run the electrostatic solve every N steps (0 = never; the round-1
    #: one-shot behavior).  Requires ``sigma_T``.
    resolve_every: int = 0

    def __post_init__(self):
        if self.resolve_every and self.sigma_T is None:
            raise ValueError("resolve_every > 0 requires sigma_T")
        fes = None
        if self.cartesian is not None:
            from ..fem.cartesian import CartesianFESpace

            fes = CartesianFESpace(self.mesh, self.order, tuple(self.cartesian))
        self.rf = rf_laplace.solve(
            self.mesh, self.order, self.sigma,
            self.electrode_bdr, self.ground_bdr, self.voltage,
            dtype=self.dtype, fes=fes,
        )
        self.fes = self.rf.fes
        self.op = bioheat.BioheatOperator(
            fes=self.fes, rho_c=self.rho_c, k=self.k_th, w_cb=self.w_cb,
            T_a=self.T_a, q_met=self.q_met, q_rf=self.rf.sar_q,
            ess_bdr=self.body_bdr, rel_tol=self.rel_tol, dtype=self.dtype,
        )
        self._solver = ode.select(self.solver)
        op, solver = self.op, self._solver
        A, Ea = self.arr_A, self.arr_Ea

        def rate(Tl):
            # Arrhenius damage rate at quadrature points (T in °C)
            Tq = values_at_quad(self.fes, Tl, dtype=self.dtype)
            return arrhenius_rate(Tq, A, Ea)

        def _step(T, omega_q, t, dt):
            T2, t2 = solver.step(op, T, t, dt)
            # trapezoidal Arrhenius accumulation
            omega_q = omega_q + 0.5 * dt * (rate(T) + rate(T2))
            return T2, omega_q, t2

        self.step = jax.jit(_step)
        self._setup_coupled()

    def _setup_coupled(self):
        """Jitted coupled step with dynamic SAR source and optional k(T)."""
        from ..fem.build import basis_for, restriction_for
        from ..fem.quadinterp import eval_values, eval_values_t
        from ..ops import diffusion, mass

        op, solver = self.op, self._solver
        fes = self.fes
        gf = geom_factors_for(fes, dtype=self.dtype)
        restr = restriction_for(fes)
        db = basis_for(fes, dtype=self.dtype)
        A, Ea = self.arr_A, self.arr_Ea
        k_T = self.k_T

        def _view(T, sar_q):
            """Operator view with the step's dynamic qdata folded in."""
            q = op.Mw_qd * self.T_a + gf.wdet * sar_q
            kw = dict(b_const=restr.mult_transpose(eval_values_t(db, q)))
            if k_T is not None:
                Tq = eval_values(db, restr.mult(T))
                K_qd = diffusion.setup_packed(gf, k_T(Tq))
                kw["K_qd"] = K_qd
                kw["A_diag"] = restr.mult_transpose(
                    diffusion.diagonal(db, K_qd)
                    + mass.diagonal(db, op.Mw_qd)
                )
            return op.override(**kw)

        def rate(Tl):
            return arrhenius_rate(eval_values(db, restr.mult(Tl)), A, Ea)

        def _step_coupled(T, omega_q, t, dt, sar_q):
            T2, t2 = solver.step(_view(T, sar_q), T, t, dt)
            omega_q = omega_q + 0.5 * dt * (rate(T) + rate(T2))
            return T2, omega_q, t2

        self.step_coupled = jax.jit(_step_coupled)
        if self.resolve_every:
            self.rf_op = rf_laplace.RFOperator(
                fes=fes, electrode_bdr=self.electrode_bdr,
                ground_bdr=self.ground_bdr, voltage=self.voltage,
                rel_tol=self.rel_tol, dtype=self.dtype,
            )

            def _sigma_q(T):
                from ..fem.quadinterp import eval_values as ev

                Tq = ev(db, restr.mult(T))
                return self.sigma_T(Tq)

            self._sigma_q = jax.jit(_sigma_q)

    def initial_state(self):
        dt_ = real_t(self.dtype)
        T = jnp.full(self.fes.ndof, self.T_a, dtype=dt_)
        gf = geom_factors_for(self.fes, dtype=self.dtype)
        omega_q = jnp.zeros_like(gf.det)
        return T, omega_q

    def run(self, t_final: float, dt: float, T=None, omega_q=None, t0=0.0):
        """Advance to t_final; returns (T, omega_q, t).

        With ``resolve_every`` > 0 the electrostatic potential is re-solved
        every N steps with σ(T) (warm-started from the previous Φ), and the
        updated SAR source feeds the thermal step — the joule.cpp coupling
        loop.  With ``k_T`` set, the thermal conductivity is re-evaluated
        from the step-start temperature every step (lagged linearization,
        the ex16 ``SetParameters`` pattern)."""
        if T is None:
            T, omega_q = self.initial_state()
        t = t0
        n = int(round((t_final - t0) / dt))
        coupled = bool(self.resolve_every) or self.k_T is not None
        if not coupled:
            for _ in range(n):
                T, omega_q, t = self.step(T, omega_q, t, dt)
            return T, omega_q, t

        sar_q = self.rf.sar_q
        phi = self.rf.phi
        for i in range(n):
            if self.resolve_every and i % self.resolve_every == 0:
                phi, sar_q, _ = self.rf_op.resolve(self._sigma_q(T), phi)
            T, omega_q, t = self.step_coupled(T, omega_q, t, dt, sar_q)
        self.phi, self.sar_q = phi, sar_q
        return T, omega_q, t

    def lesion_volume(self, omega_q) -> float:
        """Volume where Ω ≥ 1 (63% protein denaturation)."""
        gf = geom_factors_for(self.fes, dtype=self.dtype)
        return float(jnp.sum(gf.wdet * (omega_q >= 1.0)))
