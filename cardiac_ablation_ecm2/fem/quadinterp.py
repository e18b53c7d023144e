"""E-vector → Q-vector evaluation (QuadratureInterpolator).

Reference analog: ``fem/quadinterpolator.hpp:56-74`` (VALUES / DERIVATIVES
flags) with the sum-factorized kernels of ``fem/qinterp/``.

Design: every contraction is a ``jnp.einsum`` against the 1D
``B1/G1`` factors — XLA fuses these into batched matmuls.  The
ordering convention throughout: E-vectors are ``(ne, nd)`` lex-flat (i
fastest); the tensor reshape ``(ne, n1, n1, n1)`` therefore has axes
``(e, k, j, i)`` and Q-vectors come back lex-flat ``(ne, nq)`` with qx
fastest.  The transpose functions implement the exact adjoints (Bᵀ/Gᵀ
contractions) used by operator applies.

All functions are jit-safe pure functions of (matrices, data).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

#: float32 contraction precision (see utils.config.Config.matmul_precision).
#: On an NVIDIA GPU "default" and "high" allow TF32 tensor-core products
#: (10-bit mantissa, ~1e-3 relative per product); "highest" keeps true f32.
_PRECS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _es(spec, *ops):
    from ..utils.config import config

    return jnp.einsum(spec, *ops, precision=_PRECS[config.matmul_precision])

from ..utils.config import real_t
from .basis import DofToQuad


@dataclasses.dataclass(frozen=True)
class DeviceBasis:
    """Device-resident DofToQuad matrices at the working dtype."""

    dim: int
    tensor: bool
    B1: Optional[jnp.ndarray] = None   # (nq1, n1)
    G1: Optional[jnp.ndarray] = None
    B: Optional[jnp.ndarray] = None    # (nq, nd)
    G: Optional[jnp.ndarray] = None    # (nq, nd, dim)
    W: Optional[jnp.ndarray] = None    # (nq,) quadrature weights

    @property
    def n1d(self):
        return self.B1.shape[1]

    @property
    def nq1d(self):
        return self.B1.shape[0]


@functools.lru_cache(maxsize=None)
def _device_basis_cached(d2q: DofToQuad, dtype_str: str) -> DeviceBasis:
    dt = jnp.dtype(dtype_str)
    kw = dict(dim=d2q.dim, tensor=d2q.tensor, W=jnp.asarray(d2q.weights, dt))
    if d2q.tensor:
        return DeviceBasis(
            B1=jnp.asarray(d2q.B1, dt), G1=jnp.asarray(d2q.G1, dt), **kw
        )
    return DeviceBasis(B=jnp.asarray(d2q.B, dt), G=jnp.asarray(d2q.G, dt), **kw)


def device_basis(d2q: DofToQuad, dtype=None) -> DeviceBasis:
    return _device_basis_cached(d2q, str(real_t(dtype)))


# ----------------------------------------------------------------------------
# forward: E → Q
# ----------------------------------------------------------------------------


def _t3(u, n1):
    return u.reshape(u.shape[0], n1, n1, n1, *u.shape[2:])


def eval_values(db: DeviceBasis, u_e: jnp.ndarray) -> jnp.ndarray:
    """(ne, nd[, c]) → (ne, nq[, c]) basis values at quadrature points."""
    extra = u_e.ndim - 2
    if not db.tensor:
        return _es("qn,en...->eq...", db.B, u_e)
    B = db.B1
    n1 = db.n1d
    ne = u_e.shape[0]
    if db.dim == 1:
        return _es("qi,ei...->eq...", B, u_e)
    if db.dim == 2:
        u = u_e.reshape(ne, n1, n1, *u_e.shape[2:])          # (e, j, i, ...)
        t = _es("ai,eji...->eja...", B, u)
        t = _es("bj,eja...->eba...", B, t)
        return t.reshape(ne, -1, *u_e.shape[2:]) if extra else t.reshape(ne, -1)
    u = _t3(u_e, n1)                                          # (e, k, j, i, ...)
    t = _es("ai,ekji...->ekja...", B, u)
    t = _es("bj,ekja...->ekba...", B, t)
    t = _es("ck,ekba...->ecba...", B, t)
    return t.reshape(ne, -1, *u_e.shape[2:])


def eval_values_t(db: DeviceBasis, q: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of eval_values: (ne, nq[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qn,eq...->en...", db.B, q)
    B = db.B1
    nq1 = db.nq1d
    ne = q.shape[0]
    if db.dim == 1:
        return _es("qi,eq...->ei...", B, q)
    if db.dim == 2:
        v = q.reshape(ne, nq1, nq1, *q.shape[2:])             # (e, b, a, ...)
        t = _es("ai,eba...->ebi...", B, v)
        t = _es("bj,ebi...->eji...", B, t)
        return t.reshape(ne, -1, *q.shape[2:])
    v = q.reshape(ne, nq1, nq1, nq1, *q.shape[2:])            # (e, c, b, a, ...)
    t = _es("ai,ecba...->ecbi...", B, v)
    t = _es("bj,ecbi...->ecji...", B, t)
    t = _es("ck,ecji...->ekji...", B, t)
    return t.reshape(ne, -1, *q.shape[2:])


def eval_grad(db: DeviceBasis, u_e: jnp.ndarray) -> jnp.ndarray:
    """Reference-space gradients: (ne, nd[, c]) → (ne, nq, dim[, c])."""
    if not db.tensor:
        return _es("qnd,en...->eqd...", db.G, u_e)
    B, G = db.B1, db.G1
    n1 = db.n1d
    ne = u_e.shape[0]
    extra = u_e.shape[2:]
    if db.dim == 1:
        g = _es("qi,ei...->eq...", G, u_e)
        return jnp.expand_dims(g, 2)
    if db.dim == 2:
        u = u_e.reshape(ne, n1, n1, *extra)
        gx = _es("bj,eja...->eba...", B, _es("ai,eji...->eja...", G, u))
        gy = _es("bj,eja...->eba...", G, _es("ai,eji...->eja...", B, u))
        g = jnp.stack([gx.reshape(ne, -1, *extra), gy.reshape(ne, -1, *extra)], axis=2)
        return g
    u = _t3(u_e, n1)
    def _c(Fx, Fy, Fz):
        t = _es("ai,ekji...->ekja...", Fx, u)
        t = _es("bj,ekja...->ekba...", Fy, t)
        t = _es("ck,ekba...->ecba...", Fz, t)
        return t.reshape(ne, -1, *extra)
    g = jnp.stack([_c(G, B, B), _c(B, G, B), _c(B, B, G)], axis=2)
    return g


def eval_grad_t(db: DeviceBasis, q: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of eval_grad: (ne, nq, dim[, c]) → (ne, nd[, c])."""
    if not db.tensor:
        return _es("qnd,eqd...->en...", db.G, q)
    B, G = db.B1, db.G1
    nq1 = db.nq1d
    ne = q.shape[0]
    extra = q.shape[3:]
    if db.dim == 1:
        return _es("qi,eq...->ei...", G, q[:, :, 0])
    if db.dim == 2:
        v = q.reshape(ne, nq1, nq1, 2, *extra)
        def _ct(Fx, Fy, comp):
            t = _es("ai,eba...->ebi...", Fx, v[:, :, :, comp])
            t = _es("bj,ebi...->eji...", Fy, t)
            return t.reshape(ne, -1, *extra)
        return _ct(G, B, 0) + _ct(B, G, 1)
    v = q.reshape(ne, nq1, nq1, nq1, 3, *extra)
    def _ct3(Fx, Fy, Fz, comp):
        t = _es("ai,ecba...->ecbi...", Fx, v[:, :, :, :, comp])
        t = _es("bj,ecbi...->ecji...", Fy, t)
        t = _es("ck,ecji...->ekji...", Fz, t)
        return t.reshape(ne, -1, *extra)
    return _ct3(G, B, B, 0) + _ct3(B, G, B, 1) + _ct3(B, B, G, 2)


def contract_q_to_e(factors: Tuple[jnp.ndarray, ...], q: jnp.ndarray) -> jnp.ndarray:
    """Transpose contraction with distinct per-axis 1D factors.

    ``factors[d]`` has shape (nq1, n1) for reference axis d (x, y, z).  Maps
    (ne, nq[, c]) → (ne, nd[, c]).  Used by PA diagonal assembly where the
    per-axis factor is an elementwise product like B∘G.
    """
    dim = len(factors)
    nq1 = factors[0].shape[0]
    ne = q.shape[0]
    extra = q.shape[2:]
    if dim == 1:
        return _es("qi,eq...->ei...", factors[0], q)
    if dim == 2:
        v = q.reshape(ne, nq1, nq1, *extra)
        t = _es("ai,eba...->ebi...", factors[0], v)
        t = _es("bj,ebi...->eji...", factors[1], t)
        return t.reshape(ne, -1, *extra)
    v = q.reshape(ne, nq1, nq1, nq1, *extra)
    t = _es("ai,ecba...->ecbi...", factors[0], v)
    t = _es("bj,ecbi...->ecji...", factors[1], t)
    t = _es("ck,ecji...->ekji...", factors[2], t)
    return t.reshape(ne, -1, *extra)
