"""Transient magnetic diffusion on H(curl) — the joule/maxwell-miniapp
transient EM slice.

Reference analog: ``miniapps/electromagnetics/joule_solver.cpp`` (the
magnetic-diffusion substep σ ∂A/∂t + curl(ν curl A) = J_s) and the
``maxwell.cpp`` transient solver.

Design: a TimeDependentOperator on the ND space — implicit SDIRK
stages solve (σM + γ CC) k = rhs with Jacobi-PCG, everything inside jit;
B = curl A stays divergence-free to machine precision through the
discrete de Rham curl."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..linalg.solvers import cg
from ..ops.vecfe import build_nd_operator, vecfe_linear_form
from ..utils.config import real_t


@dataclasses.dataclass(eq=False)
class MagneticDiffusionOperator:
    """σ dA/dt = −curl(ν curl A) + J_s, PEC (n×A = 0) on marked attrs."""

    nd_space: object
    sigma: float = 1.0
    nu: float = 1.0
    source: object = None          # J_s(x) callable or None
    ess_bdr: Optional[Sequence[int]] = None
    nq1d: int = 3
    rel_tol: float = 1e-10
    max_iter: int = 2000
    dtype: object = None

    def __post_init__(self):
        rt = real_t(self.dtype)
        sp = self.nd_space
        self.M = build_nd_operator(sp, mass_coeff=self.sigma,
                                   curlcurl_coeff=None, nq1d=self.nq1d,
                                   dtype=self.dtype)
        self.CC = build_nd_operator(sp, mass_coeff=None,
                                    curlcurl_coeff=self.nu,
                                    nq1d=self.nq1d, dtype=self.dtype)
        self.b = (vecfe_linear_form(self.M, self.source) / self.sigma
                  if self.source is not None
                  else jnp.zeros(self.M.ndof, rt))
        if self.ess_bdr:
            ess = sp.essential_dofs(self.ess_bdr)
        else:
            ess = np.zeros(0, np.int32)
        mask = np.ones(self.M.ndof)
        mask[ess] = 0.0
        self.mask = jnp.asarray(mask, rt)
        self.dM = self.M.diagonal() * self.mask + (1 - self.mask)
        self.dCC = self.CC.diagonal()

    def residual(self, A):
        return (self.b - self.CC.mult(A)) * self.mask

    def mult(self, t, A):
        """dA/dt = M⁻¹ (J_s − CC A)."""
        rhs = self.residual(A)
        m = self.mask

        def Mc(v):
            z = v * m
            return self.M.mult(z) * m + (v - z)

        x, _ = cg(Mc, rhs, M=lambda r: r / self.dM,
                  rel_tol=self.rel_tol, max_iter=self.max_iter)
        return x * m

    def implicit_solve(self, gamma, t, A):
        """(M + γ CC) k = J_s − CC A."""
        rhs = self.residual(A)
        m = self.mask

        def lhs(v):
            z = v * m
            y = self.M.mult(z) + gamma * self.CC.mult(z)
            return y * m + (v - z)

        dg = self.dM + gamma * self.dCC * self.mask
        k, _ = cg(lhs, rhs, M=lambda r: r / dg,
                  rel_tol=self.rel_tol, max_iter=self.max_iter)
        return k * m
