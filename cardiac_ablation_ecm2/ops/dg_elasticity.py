"""DG (interior penalty) linear elasticity — the ex17 capability.

Reference analog: ``DGElasticityIntegrator`` (``fem/bilininteg.hpp:3018``)
driven as in ``examples/ex17.cpp`` (SIPG form, weak Dirichlet):

  a(u,v) = Σ_K ∫ σ(u):ε(v) − Σ_F ∮ {σ(u)n}·[v] − ∮ {σ(v)n}·[u]
         + Σ_F (α(λ̄+2μ̄)/h) ∮ [u]·[v],     σ(u) = λ tr(ε)I + 2με.

Design: the traction operator at face points and its exact adjoint
are batched einsums over the face-data tables (per-face scalar basis
values + gradients); the volume term reuses the elasticity PA kernel on
the broken vector E-layout (ne, nd, dim)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for
from ..fem.faces import build_face_data
from ..fem.fespace import L2FESpace
from ..utils.config import index_t, real_t
from . import elasticity as emod
from .operators import LinearOperator


def _traction(G, nrm, u_e, lam, mu):
    """σ(u)n at face qpts: (f, q, c) from per-component gradients."""
    Gu = jnp.einsum("fqnd,fnc->fqcd", G, u_e)       # ∂_d u_c
    div = jnp.einsum("fqcc->fq", Gu)
    t = (lam * div[..., None] * nrm
         + mu * jnp.einsum("fqcd,fqd->fqc", Gu + jnp.swapaxes(Gu, 2, 3),
                           nrm))
    return t


def _traction_T(G, nrm, m, lam, mu):
    """Exact adjoint: given m (f, q, c), distribute ⟨m, σ(·)n⟩ to dofs
    → (f, n, e)."""
    mn = jnp.einsum("fqc,fqc->fq", m, nrm)          # m·n
    nG = jnp.einsum("fqd,fqnd->fqn", nrm, G)        # n·∇φ_n
    mG = jnp.einsum("fqc,fqnc->fqn", m, G)          # Σ_c m_c ∂_c φ_n
    out = (lam * mn[..., None, None] * G
           + mu * nG[..., None] * m[:, :, None, :]
           + mu * mG[..., None] * nrm[:, :, None, :])
    return jnp.sum(out, axis=1)                     # Σ_q → (f, n, e)


@dataclasses.dataclass(eq=False)
class DGElasticity:
    """Matrix-free SIPG elasticity operator on a broken vector space."""

    fes: L2FESpace                 # scalar broken space (per component)
    lam: float = 1.0
    mu: float = 1.0
    penalty: float = 10.0
    nq1d: Optional[int] = None
    dtype: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        rt = real_t(self.dtype)
        p = fes.order
        self.dim = mesh.dim
        self.db = basis_for(fes, self.nq1d, self.dtype)
        gf = geom_factors_for(fes, self.nq1d, self.dtype)
        self.vol_qd = emod.setup(gf, self.lam, self.mu)

        fd = build_face_data(mesh, p, self.nq1d, with_gradients=True)
        self.e0 = jnp.asarray(fd.elem0, index_t())
        self.e1 = jnp.asarray(fd.elem1, index_t())
        self.B0 = jnp.asarray(fd.B0, rt)
        self.B1 = jnp.asarray(fd.B1, rt)
        self.G0 = jnp.asarray(fd.G0, rt)
        self.G1 = jnp.asarray(fd.G1, rt)
        self.nrm = jnp.asarray(fd.normal, rt)
        self.w_f = jnp.asarray(fd.wdet, rt)
        alpha = self.penalty * max(p, 1) * (p + 1)
        kbar = self.lam + 2 * self.mu
        hmean = 2.0 / (1.0 / fd.h0 + 1.0 / fd.h1)
        self.pen = jnp.asarray(alpha * kbar / hmean, rt)

        self.be = jnp.asarray(fd.b_elem, index_t())
        self.bB = jnp.asarray(fd.b_B, rt)
        self.bG = jnp.asarray(fd.b_G, rt)
        self.bn = jnp.asarray(fd.b_normal, rt)
        self.bw = jnp.asarray(fd.b_wdet, rt)
        self.bpen = jnp.asarray(alpha * kbar / fd.b_h, rt)
        self.b_xq = fd.b_xq
        self.ne = mesh.ne

    @property
    def ndof(self):
        return self.ne * self.fes.nd_elem * self.dim

    def mult(self, u_flat: jnp.ndarray) -> jnp.ndarray:
        ne, nd, d = self.ne, self.fes.nd_elem, self.dim
        u = u_flat.reshape(ne, nd, d)
        y = emod.apply(self.db, self.vol_qd, u)

        lam, mu = self.lam, self.mu
        u0 = jnp.einsum("fqn,fnc->fqc", self.B0, u[self.e0])
        u1 = jnp.einsum("fqn,fnc->fqc", self.B1, u[self.e1])
        t0 = _traction(self.G0, self.nrm, u[self.e0], lam, mu)
        t1 = _traction(self.G1, self.nrm, u[self.e1], lam, mu)
        jump = u0 - u1
        avg = 0.5 * (t0 + t1)
        # consistency − ∮ {σ(u)n}·[v]
        t = self.w_f[..., None] * avg
        y = y.at[self.e0].add(-jnp.einsum("fqn,fqc->fnc", self.B0, t))
        y = y.at[self.e1].add(jnp.einsum("fqn,fqc->fnc", self.B1, t))
        # symmetry − ∮ {σ(v)n}·[u]
        s = 0.5 * self.w_f[..., None] * jump
        y = y.at[self.e0].add(-_traction_T(self.G0, self.nrm, s, lam, mu))
        y = y.at[self.e1].add(-_traction_T(self.G1, self.nrm, s, lam, mu))
        # penalty
        pw = self.pen[:, None, None] * self.w_f[..., None] * jump
        y = y.at[self.e0].add(jnp.einsum("fqn,fqc->fnc", self.B0, pw))
        y = y.at[self.e1].add(-jnp.einsum("fqn,fqc->fnc", self.B1, pw))

        # boundary (weak Dirichlet, u⁺ ≡ 0)
        ub = jnp.einsum("fqn,fnc->fqc", self.bB, u[self.be])
        tb = _traction(self.bG, self.bn, u[self.be], lam, mu)
        y = y.at[self.be].add(
            -jnp.einsum("fqn,fqc->fnc", self.bB, self.bw[..., None] * tb)
            - _traction_T(self.bG, self.bn, self.bw[..., None] * ub,
                          lam, mu)
            + jnp.einsum("fqn,fqc->fnc", self.bB,
                         self.bpen[:, None, None]
                         * self.bw[..., None] * ub))
        return y.reshape(-1)

    def dirichlet_rhs(self, g: Callable) -> jnp.ndarray:
        """Weak Dirichlet RHS: −∮ σ(v)n·g + (α k̄/h) ∮ v·g."""
        gq = jnp.asarray(g(self.b_xq), self.bw.dtype)   # (nfb, nq, dim)
        b = (-_traction_T(self.bG, self.bn, self.bw[..., None] * gq,
                          self.lam, self.mu)
             + jnp.einsum("fqn,fqc->fnc", self.bB,
                          self.bpen[:, None, None]
                          * self.bw[..., None] * gq))
        ne, nd, d = self.ne, self.fes.nd_elem, self.dim
        out = jnp.zeros((ne, nd, d), dtype=self.bw.dtype)
        out = out.at[self.be].add(b)
        return out.reshape(-1)

    def diagonal(self) -> jnp.ndarray:
        """Jacobi diagonal (volume + penalty mass terms)."""
        d = emod.diagonal(self.db, self.vol_qd)          # (ne, nd, dim)
        pd = jnp.einsum("f,fq,fqn,fqn->fn", self.pen, self.w_f,
                        self.B0, self.B0)
        d = d.at[self.e0].add(pd[..., None])
        pd1 = jnp.einsum("f,fq,fqn,fqn->fn", self.pen, self.w_f,
                         self.B1, self.B1)
        d = d.at[self.e1].add(pd1[..., None])
        pb = jnp.einsum("f,fq,fqn,fqn->fn", self.bpen, self.bw,
                        self.bB, self.bB)
        d = d.at[self.be].add(pb[..., None])
        return d.reshape(-1)

    def operator(self) -> LinearOperator:
        n = self.ndof
        return LinearOperator((n, n), self.mult, self.diagonal)
