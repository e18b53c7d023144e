"""Hyperbolic conservation laws on DG spaces: u_t + ∇·F(u) = 0.

Reference analog: the hyperbolic framework of ``fem/hyperbolic.cpp``
(``HyperbolicFormIntegrator`` + ``RiemannSolver``/Rusanov) and
``examples/ex18.cpp`` (compressible Euler).

Design: the semidiscrete operator is

    M du/dt = ∫ F(u) : ∇w dx − ∮ F̂(u⁻, u⁺, n)·w dS

with the Rusanov (local Lax-Friedrichs) numerical flux.  State is an
(ne·nd, nc) array (nc conserved components); volume terms are the
transpose-gradient einsums, face terms batched per-face matmuls — all flux
evaluations are plain jnp functions of the state, so new conservation laws
are one flux + one wave-speed function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for
from ..fem.faces import build_face_data
from ..fem.fespace import L2FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad_t, eval_values
from ..utils.config import index_t, real_t
from . import mass as mmod


# ----------------------------------------------------------------------------
# flux libraries (fem/hyperbolic.cpp analogs)
# ----------------------------------------------------------------------------


def burgers_flux(u, dim):
    """F(u) = ½u²·(1,…,1) (BurgersFlux).  u: (..., 1) → (..., 1, dim)."""
    f = 0.5 * u[..., 0] ** 2
    return jnp.stack([f] * dim, axis=-1)[..., None, :]


def burgers_max_speed(uL, uR, n):
    return jnp.maximum(jnp.abs(uL[..., 0]), jnp.abs(uR[..., 0])) * jnp.sqrt(
        float(n.shape[-1])
    )


def euler_flux(q, dim, gamma=1.4):
    """Compressible Euler (EulerFlux): q = (ρ, ρv…, E) → (..., nc, dim)."""
    rho = q[..., 0]
    mom = q[..., 1 : 1 + dim]
    E = q[..., 1 + dim]
    v = mom / rho[..., None]
    p = (gamma - 1.0) * (E - 0.5 * jnp.sum(mom * v, axis=-1))
    rows = [mom]                                            # ρv
    for i in range(dim):
        r = mom[..., i : i + 1] * v                          # ρ v_i v
        r = r.at[..., i].add(p)
        rows.append(r)
    rows.append((E + p)[..., None] * v)                      # (E+p)v
    return jnp.stack(rows, axis=-2)                          # (..., nc, dim)


def euler_max_speed(qL, qR, n, gamma=1.4):
    def speed(q):
        rho = q[..., 0]
        dim = n.shape[-1]
        mom = q[..., 1 : 1 + dim]
        E = q[..., 1 + dim]
        v = mom / rho[..., None]
        p = (gamma - 1.0) * (E - 0.5 * jnp.sum(mom * v, axis=-1))
        c = jnp.sqrt(jnp.maximum(gamma * p / rho, 1e-30))
        vn = jnp.sum(v * n, axis=-1)
        return jnp.abs(vn) + c

    return jnp.maximum(speed(qL), speed(qR))


FLUXES = {
    "burgers": (burgers_flux, burgers_max_speed, 1),
    "euler": (euler_flux, euler_max_speed, None),   # nc = dim + 2
}


@dataclasses.dataclass(eq=False)
class HyperbolicDG:
    """Rusanov-flux DG operator for u_t = −∇·F(u) (explicit RK stepping)."""

    fes: L2FESpace
    law: str = "burgers"
    nq1d: Optional[int] = None
    dtype: object = None
    gamma: float = 1.4

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        dim = mesh.dim
        rt = real_t(self.dtype)
        flux, speed, nc = FLUXES[self.law]
        self.nc = (dim + 2) if nc is None else nc
        if self.law == "euler":
            self.flux = lambda u: euler_flux(u, dim, self.gamma)
            self.speed = lambda a, b, n: euler_max_speed(a, b, n, self.gamma)
        else:
            self.flux = lambda u: flux(u, dim)
            self.speed = speed
        self.db = basis_for(fes, self.nq1d, self.dtype)
        gf = geom_factors_for(fes, self.nq1d, self.dtype)
        A = adjugate(gf.jac)
        self.adj_w = A * gf.w[None, :, None, None]      # (ne, nq, d, d)

        d2q = fes.d2q if self.nq1d is None else fes.dof_to_quad(self.nq1d)
        B = d2q.full_B()
        qd = np.asarray(mmod.setup(gf))
        Me = np.einsum("qm,eq,qn->emn", B, qd, B)
        self.Minv = jnp.asarray(np.linalg.inv(Me), rt)

        fd = build_face_data(mesh, fes.order, self.nq1d)
        self.e0 = jnp.asarray(fd.elem0, index_t())
        self.e1 = jnp.asarray(fd.elem1, index_t())
        self.B0 = jnp.asarray(fd.B0, rt)
        self.B1 = jnp.asarray(fd.B1, rt)
        self.n_f = jnp.asarray(fd.normal, rt)
        self.w_f = jnp.asarray(fd.wdet, rt)
        self.be = jnp.asarray(fd.b_elem, index_t())
        self.bB = jnp.asarray(fd.b_B, rt)
        self.bn = jnp.asarray(fd.b_normal, rt)
        self.bw = jnp.asarray(fd.b_wdet, rt)
        self.ne = mesh.ne

    def mult(self, t, u_flat: jnp.ndarray) -> jnp.ndarray:
        ne, nd, nc = self.ne, self.fes.nd_elem, self.nc
        u = u_flat.reshape(ne, nd, nc)

        # volume: ∫ F(u) : ∇w  (pulled back: Σ_q w adj F : ∇̂w)
        uq = eval_values(self.db, u)                        # (ne, nq, nc)
        Fq = self.flux(uq)                                  # (ne, nq, nc, d)
        W = jnp.einsum("eqrd,eqcd->eqrc", self.adj_w, Fq)   # ref-grad weights
        y = eval_grad_t(self.db, W)                         # (ne, nd, nc)

        # interior faces: Rusanov flux
        u0 = jnp.einsum("fqn,fnc->fqc", self.B0, u[self.e0])
        u1 = jnp.einsum("fqn,fnc->fqc", self.B1, u[self.e1])
        F0 = jnp.einsum("fqcd,fqd->fqc", self.flux(u0), self.n_f)
        F1 = jnp.einsum("fqcd,fqd->fqc", self.flux(u1), self.n_f)
        lam = self.speed(u0, u1, self.n_f)
        Fs = 0.5 * (F0 + F1) - 0.5 * lam[..., None] * (u1 - u0)
        Fs = Fs * self.w_f[..., None]
        y = y.at[self.e0].add(-jnp.einsum("fqn,fqc->fnc", self.B0, Fs))
        y = y.at[self.e1].add(jnp.einsum("fqn,fqc->fnc", self.B1, Fs))

        # boundary: transmissive (copy interior state)
        ub = jnp.einsum("fqn,fnc->fqc", self.bB, u[self.be])
        Fb = jnp.einsum("fqcd,fqd->fqc", self.flux(ub), self.bn)
        Fb = Fb * self.bw[..., None]
        y = y.at[self.be].add(-jnp.einsum("fqn,fqc->fnc", self.bB, Fb))

        out = jnp.einsum("emn,enc->emc", self.Minv, y)
        return out.reshape(-1)
