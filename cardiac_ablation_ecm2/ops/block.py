"""Block operators and the RT×L2 mixed divergence coupling.

Reference analog: ``BlockOperator`` / ``BlockDiagonalPreconditioner``
(``linalg/blockoperator.hpp:34,148``) and the mixed
``VectorFEDivergenceIntegrator`` used by ex5's Darcy saddle point.

Design: a block operator is a function on one concatenated flat vector
(static offsets) — Krylov solvers need no block awareness.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..fem.fe_vector import RTSpace, rt0_basis
from ..utils.config import index_t, real_t


@dataclasses.dataclass(eq=False)
class BlockOperator:
    """2×2 block operator on concatenated vectors [u; p]."""

    n0: int
    n1: int
    A00: Callable
    A01: Callable         # maps block-1 vec → block-0 vec
    A10: Callable
    A11: Callable = None  # None = zero block

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        u, p = x[: self.n0], x[self.n0:]
        y0 = self.A00(u) + self.A01(p)
        y1 = self.A10(u)
        if self.A11 is not None:
            y1 = y1 + self.A11(p)
        return jnp.concatenate([y0, y1])


def block_diag_precond(M0: Callable, M1: Callable, n0: int) -> Callable:
    def prec(r):
        return jnp.concatenate([M0(r[:n0]), M1(r[n0:])])

    return prec


def mixed_divergence(rt_space: RTSpace, l2_fes, nq1d: int = 3, dtype=None):
    """B: RT0 → L2' with (B u)_m = (div u, q_m); returns (B, Bt) callables.

    (VectorFEDivergenceIntegrator analog; div_phys = div_ref / detJ so the
    w·detJ quadrature weight cancels to w·div_ref — exact for RT0.)
    """
    from ..fem.basis import make_dof_to_quad

    mesh = rt_space.mesh
    rt = real_t(dtype)
    _, _, Dref = rt0_basis(mesh.geom, nq1d)           # (nq, nfl)
    d2q = make_dof_to_quad(mesh.geom, l2_fes.order, nq1d)
    Bl2 = d2q.full_B()                                # (nq, ndl2)
    from ..fem.intrules import tensor_rule

    _, w = tensor_rule(mesh.dim, nq1d)
    # elem matrix: D[m, n] = Σ_q w_q Bl2[q,m] Dref[q,n] (no geometry!)
    Dmat = jnp.asarray(np.einsum("q,qm,qn->mn", w, Bl2, Dref), rt)

    g_rt = jnp.asarray(rt_space.gather_map, index_t())
    sg = jnp.asarray(rt_space.signs, rt)
    g_l2 = jnp.asarray(l2_fes.gather_map, index_t())
    n_rt, n_l2 = rt_space.ndof, l2_fes.ndof_scalar

    def B(u):
        e = u[g_rt] * sg                              # (ne, nfl)
        v = jnp.einsum("mn,en->em", Dmat, e)          # (ne, ndl2)
        out = jnp.zeros(n_l2, dtype=u.dtype)
        return out.at[g_l2.reshape(-1)].add(v.reshape(-1))

    def Bt(p):
        pe = p[g_l2]                                  # (ne, ndl2)
        v = jnp.einsum("mn,em->en", Dmat, pe) * sg
        out = jnp.zeros(n_rt, dtype=p.dtype)
        return out.at[g_rt.reshape(-1)].add(v.reshape(-1))

    return B, Bt
