"""Lane-major (transposed) full-matrix PA applies — the shared fast path.

The E-vector is laid out ``(nd, ne)``: every basis contraction becomes a
``(nq, nd) @ (nd, ne)`` matmul with the ELEMENT axis as the wide matmul
dimension instead of contracting over small trailing dims.  It gives ~10×
lower fp error vs the f64 reference than the staged einsum chain (full-width
HIGHEST matmuls accumulate better); this module shares it so
mass/diffusion/convection, ``BilinearForm``/``PAOperator``, and the BP
harness all share one code path.

Works for tensor-product bases (full matrices built once by Kronecker
product of the 1D ``B1/G1`` factors, dims 1/2/3) and for non-tensor simplex
bases (``db.B`` / ``db.G`` already ARE the full matrices) — tets get the
same treatment for free.

Reference analog: ``DofToQuad::Mode::FULL`` (``fem/fe/fe_base.hpp:140``) —
the dense dofs→quads matrices MFEM reserves for non-tensor elements, used
here for ALL elements at production orders because a dense ``(nq × nd)``
matmul with ``ne`` as the wide axis is used up to ``nd ≈ 256`` (p ≤ 5
hexes).  Above that, callers fall back to the
staged sum-factorized path (``fem/quadinterp.py``).

Layout conventions (matching ``fem/quadinterp.py``): E-vectors are lex-flat
with x fastest, so the full matrix acting on a flattened ``(k, j, i)``
tensor is ``kron(Fz, Fy, Fx)`` (rightmost factor acts on the fastest index).
Packed symmetric diffusion qdata is ``[00, 11, 01]`` (2D) /
``[00, 11, 22, 01, 02, 12]`` (3D) as produced by ``diffusion.pack_sym``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import weakref

import numpy as np

from ..fem.quadinterp import DeviceBasis

#: Full-width f32 products and accumulation (no TF32): ~10× lower error
#: than the staged einsum chain.
_P = jax.lax.Precision.HIGHEST


def _mm(A, b):
    return jnp.matmul(A, b, precision=_P)


@dataclasses.dataclass(frozen=True, eq=False)
class LaneBasis:
    """Full (nq, nd) dofs→quads matrices for the lane-major apply.

    ``S`` stacks [B; G₀; …; G_{dim−1}] into one ((1+dim)·nq, nd) matrix so
    a fused value+gradient evaluation is ONE matmul instead of 1+dim —
    with small nd (tets: nd=10) one stacked matmul reads the E-vector
    once instead of 1+dim times."""

    dim: int
    Bf: jnp.ndarray                  # (nq, nd) values
    G: Tuple[jnp.ndarray, ...]       # per reference axis, (nq, nd)
    S: jnp.ndarray = None            # ((1+dim)·nq, nd) stacked [B; G...]
    SG: jnp.ndarray = None           # (dim·nq, nd) stacked [G...]

    @property
    def nd(self) -> int:
        return self.Bf.shape[1]

    @property
    def nq(self) -> int:
        return self.Bf.shape[0]


# Keyed by id(db); a weakref with an eviction callback detects id reuse
# and lets the DeviceBasis (and its device matrices) be collected — strong
# caching here was measured to pin one LaneBasis per FESpace for the
# process lifetime in AMR/convergence loops.
_CACHE: dict = {}


def _cache_put(cache, db, value):
    key = id(db)
    cache[key] = (weakref.ref(db, lambda _r, k=key, c=cache:
                              c.pop(k, None)), value)
    return value


def _cache_get(cache, db):
    hit = cache.get(id(db))
    if hit is not None and hit[0]() is db:
        return hit[1]
    return None


def lane_basis(db: DeviceBasis) -> LaneBasis:
    """Build (and cache) the full matrices for a device basis."""
    hit = _cache_get(_CACHE, db)
    if hit is not None:
        return hit
    if db.tensor:
        B1 = np.asarray(db.B1)
        G1 = np.asarray(db.G1)
        dt = B1.dtype
        if db.dim == 1:
            Bf, G = B1, (G1,)
        elif db.dim == 2:
            Bf = np.kron(B1, B1)
            G = (np.kron(B1, G1), np.kron(G1, B1))
        else:
            Bf = np.kron(B1, np.kron(B1, B1))
            G = (
                np.kron(B1, np.kron(B1, G1)),
                np.kron(B1, np.kron(G1, B1)),
                np.kron(G1, np.kron(B1, B1)),
            )
        Bfj = jnp.asarray(Bf, dt)
        Gj = tuple(jnp.asarray(g, dt) for g in G)
        lb = LaneBasis(
            dim=db.dim, Bf=Bfj, G=Gj,
            S=jnp.concatenate((Bfj,) + Gj, axis=0),
            SG=jnp.concatenate(Gj, axis=0),
        )
    else:
        G = tuple(db.G[:, :, d] for d in range(db.dim))
        lb = LaneBasis(dim=db.dim, Bf=db.B, G=G,
                       S=jnp.concatenate((db.B,) + G, axis=0),
                       SG=jnp.concatenate(G, axis=0))
    return _cache_put(_CACHE, db, lb)


def supports(db: DeviceBasis, qdata=None, kind: str = "",
             max_nd: int = 256) -> bool:
    """Whether the lane-major path applies: full matrices available and small
    enough (nd ≤ max_nd) for dense matmuls."""
    if db.tensor:
        nd = db.n1d ** db.dim
    elif db.B is not None and db.G is not None:
        nd = db.B.shape[1]
    else:
        return False
    if nd > max_nd:
        return False
    if kind == "diffusion" and qdata is not None:
        # only packed-symmetric (k, ne, nq) layout is supported
        return qdata.ndim == 3 and qdata.shape[0] in (3, 6)
    return True


# ----------------------------------------------------------------------------
# qdata transposition (done ONCE at setup; same bytes, lane-major stream)
# ----------------------------------------------------------------------------


def mass_qT(qd: jnp.ndarray) -> jnp.ndarray:
    """(ne|1, nq) → (nq, ne|1)."""
    return qd.T


def diffusion_qT(qd_packed: jnp.ndarray) -> jnp.ndarray:
    """Packed symmetric (3|6, ne|1, nq) → (3|6, nq, ne|1)."""
    return jnp.transpose(qd_packed, (0, 2, 1))


def convection_qT(qd: jnp.ndarray) -> jnp.ndarray:
    """(ne, nq, dim) → (dim, nq, ne)."""
    return jnp.transpose(qd, (2, 1, 0))


# ----------------------------------------------------------------------------
# applies — all take/return transposed E-vectors (nd, ne)
# ----------------------------------------------------------------------------


def mass_apply(lb: LaneBasis, qT: jnp.ndarray, eT: jnp.ndarray) -> jnp.ndarray:
    """Bᵀ (q ∘ (B u)) in lane-major layout."""
    return _mm(lb.Bf.T, qT * _mm(lb.Bf, eT))


def _sym_flux(lb: LaneBasis, qT: jnp.ndarray, g):
    """Packed-symmetric D·g products from gradient rows."""
    if lb.dim == 1:
        return [qT[0] * g[0]]
    if lb.dim == 2:
        gx, gy = g
        return [qT[0] * gx + qT[2] * gy, qT[2] * gx + qT[1] * gy]
    gx, gy, gz = g
    return [
        qT[0] * gx + qT[3] * gy + qT[4] * gz,
        qT[3] * gx + qT[1] * gy + qT[5] * gz,
        qT[4] * gx + qT[5] * gy + qT[2] * gz,
    ]


def _rows(t, nq, i):
    return t[i * nq:(i + 1) * nq]


def diffusion_apply(lb: LaneBasis, qT: jnp.ndarray,
                    eT: jnp.ndarray) -> jnp.ndarray:
    """Gᵀ (D ∘ (G u)), packed-symmetric qT (3|6, nq, ne|1) — stacked:
    one (dim·nq × nd) matmul each way."""
    t = _mm(lb.SG, eT)
    g = [_rows(t, lb.nq, d) for d in range(lb.dim)]
    D = _sym_flux(lb, qT, g)
    return _mm(lb.SG.T, jnp.concatenate(D, axis=0))


def convection_apply(lb: LaneBasis, qT: jnp.ndarray,
                     eT: jnp.ndarray) -> jnp.ndarray:
    """Bᵀ (q · (G u)), qT (dim, nq, ne)."""
    t = _mm(lb.SG, eT)
    s = qT[0] * _rows(t, lb.nq, 0)
    for d in range(1, lb.dim):
        s = s + qT[d] * _rows(t, lb.nq, d)
    return _mm(lb.Bf.T, s)


def mass_diffusion_apply(lb: LaneBasis, qmT: jnp.ndarray, qdT: jnp.ndarray,
                         eT: jnp.ndarray, gamma=None) -> jnp.ndarray:
    """Fused (M + γ K) v: ONE stacked ((1+dim)·nq × nd) matmul evaluates
    values + all gradients, one transposed stacked matmul accumulates —
    γ is folded into the flux so no extra passes over (nd, ne) arrays."""
    t = _mm(lb.S, eT)
    nq = lb.nq
    bu = _rows(t, nq, 0)
    g = [_rows(t, nq, 1 + d) for d in range(lb.dim)]
    D = _sym_flux(lb, qdT, g)
    if gamma is not None:
        D = [gamma * d for d in D]
    return _mm(lb.S.T, jnp.concatenate([qmT * bu] + D, axis=0))


_APPLY = {
    "mass": mass_apply,
    "diffusion": diffusion_apply,
    "convection": convection_apply,
}

_QT = {
    "mass": mass_qT,
    "diffusion": diffusion_qT,
    "convection": convection_qT,
}


def transpose_qdata(kind: str, qd: jnp.ndarray) -> jnp.ndarray:
    return _QT[kind](qd)


# ----------------------------------------------------------------------------
# affine fast path: separable qdata → reference-matrix apply
# ----------------------------------------------------------------------------
#
# For affine elements (straight-sided simplices, parallelepiped hexes) the
# Jacobian is constant per element, so every qdata array separates as
# ``qT[..., q, e] = W[q] · d[..., e]`` — detected NUMERICALLY at setup, so
# curved or distorted meshes fall back automatically.  The element matrix
# then becomes a fixed linear combination of precomputed reference matrices
#
#   K_e = Σ_c d_c[e] · K̂_c ,   K̂_(a,b) = ĜₐᵀWĜ_b (+ sym),   M̂ = BᵀWB
#
# and the whole apply is ONE ``(nd, k·nd) @ (k·nd, ne)`` matmul — the per-
# quad-point qdata stream (the dominant HBM stream on unstructured meshes:
# 6·nq·ne floats, ~620 MB for 1M p2 tets) collapses 27× to 6·ne, and the
# (3·nq, ne) gradient intermediates disappear entirely.
#
# Reference analog: MFEM stores full per-qpt qdata even on affine meshes
# (fem/integ/bilininteg_diffusion_kernels.cpp:243) — the collapse targets
# memory bandwidth, the apply's roofline.


@dataclasses.dataclass(frozen=True, eq=False)
class AffineOps:
    """Reference element matrices for the affine (separable-qdata) apply."""

    dim: int
    Mhat: jnp.ndarray                 # (nd, nd)  BᵀWB
    Khat: Tuple[jnp.ndarray, ...]     # packed-sym component mats, (nd, nd)
    Chat: Tuple[jnp.ndarray, ...]     # per axis BᵀWĜ_d, (nd, nd)


_AFF_CACHE: dict = {}


def affine_ops(db: DeviceBasis) -> AffineOps:
    """Build (and cache) ŴBᵀ-style reference matrices; f64 quad-point sums."""
    hit = _cache_get(_AFF_CACHE, db)
    if hit is not None:
        return hit
    lb = lane_basis(db)
    Bf = np.asarray(lb.Bf, np.float64)
    G = [np.asarray(g, np.float64) for g in lb.G]
    W = np.asarray(db.W, np.float64)
    dt = jnp.asarray(lb.Bf).dtype
    Mhat = Bf.T @ (W[:, None] * Bf)
    dim = lb.dim
    if dim == 1:
        pairs = [(0, 0)]
    elif dim == 2:
        pairs = [(0, 0), (1, 1), (0, 1)]
    else:
        pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    Khat = []
    for a, b in pairs:
        K = G[a].T @ (W[:, None] * G[b])
        if a != b:
            K = K + K.T
        Khat.append(jnp.asarray(K, dt))
    Chat = tuple(jnp.asarray(Bf.T @ (W[:, None] * g), dt) for g in G)
    af = AffineOps(dim=dim, Mhat=jnp.asarray(Mhat, dt),
                   Khat=tuple(Khat), Chat=Chat)
    return _cache_put(_AFF_CACHE, db, af)


def separable_collapse(qT: jnp.ndarray, W: jnp.ndarray,
                       rtol: float = 1e-5) -> Optional[jnp.ndarray]:
    """If ``qT[..., q, e] == W[q] · d[..., e]`` to ``rtol``, return ``d``
    (dtype preserved, trailing ne axis kept); else None.  Concrete check —
    call at setup time only."""
    if isinstance(qT, jax.core.Tracer) or qT.dtype == jnp.bfloat16:
        return None
    r = qT / W[:, None]
    d = jnp.mean(r, axis=-2)
    scale = float(jnp.max(jnp.abs(d)))
    if scale == 0.0:
        return jnp.zeros(d.shape, qT.dtype)
    dev = float(jnp.max(jnp.abs(r - d[..., None, :])))
    if dev <= rtol * scale:
        return d.astype(qT.dtype)
    return None


def _scaled_rows(mats, scales, eT):
    """Z = vstack(scales_i ∘ eT), MK = hstack(mats) → MK @ Z in one matmul."""
    Z = jnp.concatenate([s[None, :] * eT for s in scales], axis=0)
    MK = jnp.concatenate(mats, axis=1)
    return _mm(MK, Z)


def affine_mass_apply(af: AffineOps, d: jnp.ndarray,
                      eT: jnp.ndarray) -> jnp.ndarray:
    """M̂ @ (d ∘ eT); d is (ne|1,)."""
    return _mm(af.Mhat, d[None, :] * eT)


def affine_diffusion_apply(af: AffineOps, d: jnp.ndarray,
                           eT: jnp.ndarray) -> jnp.ndarray:
    """Σ_c K̂_c @ (d_c ∘ eT) as one stacked matmul; d is (3|6, ne|1)."""
    return _scaled_rows(af.Khat, [d[c] for c in range(d.shape[0])], eT)


def affine_convection_apply(af: AffineOps, d: jnp.ndarray,
                            eT: jnp.ndarray) -> jnp.ndarray:
    """Σ_d Ĉ_d @ (d_d ∘ eT); d is (dim, ne|1)."""
    return _scaled_rows(af.Chat, [d[c] for c in range(d.shape[0])], eT)


def affine_mass_diffusion_apply(af: AffineOps, dm, dk, eT,
                                gamma=None) -> jnp.ndarray:
    """Fused (M + γ K) v: one (nd, (1+k)·nd) @ ((1+k)·nd, ne) matmul.
    ``dm`` (ne|1,) mass factors (γ pre-folded by the caller if needed),
    ``dk`` (3|6, ne|1) diffusion factors."""
    k = dk.shape[0]
    scales = [dm] + [dk[c] if gamma is None else gamma * dk[c]
                     for c in range(k)]
    return _scaled_rows((af.Mhat,) + af.Khat[:k], scales, eT)


_AFF_APPLY = {
    "mass": affine_mass_apply,
    "diffusion": affine_diffusion_apply,
    "convection": affine_convection_apply,
}

_AFF_MATS = {
    "mass": lambda af, d: (af.Mhat,),
    "diffusion": lambda af, d: af.Khat[:d.shape[0]],
    "convection": lambda af, d: af.Chat[:d.shape[0]],
}


def try_affine(kind: str, qT: jnp.ndarray, db: DeviceBasis):
    """Collapse transposed qdata to affine factors if separable → ``d`` with
    a leading component axis (mass gets a singleton one), else None."""
    from ..utils.config import config

    if getattr(config, "affine_collapse", "auto") == "off":
        return None
    d = separable_collapse(qT, db.W)
    if d is None:
        return None
    return d[None, :] if kind == "mass" else d


def apply_terms(lb: LaneBasis, terms: Sequence[Tuple[str, jnp.ndarray]],
                eT: jnp.ndarray, af: Optional[AffineOps] = None,
                aff_terms: Sequence[Tuple[str, jnp.ndarray]] = ()
                ) -> jnp.ndarray:
    """Sum of lane-major integrator applies sharing one E-vector.  Affine
    terms (kind, d) fuse into a single stacked reference-matrix matmul."""
    out = None
    if aff_terms:
        mats, scales = [], []
        for kind, d in aff_terms:
            mats.extend(_AFF_MATS[kind](af, d))
            scales.extend(d[c] for c in range(d.shape[0]))
        out = _scaled_rows(mats, scales, eT)
    for kind, qT in terms:
        y = _APPLY[kind](lb, qT, eT)
        out = y if out is None else out + y
    return out
