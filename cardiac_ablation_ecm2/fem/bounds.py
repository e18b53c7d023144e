"""Piecewise bounds of high-order fields via Bernstein control points.

Reference analog: ``fem/bounds.cpp`` (``PLBound``) — compute per-element
lower/upper bounds of a high-order GridFunction, used for bounds checking
and bound-preserving limiting.

Design: convert the nodal E-vector to tensor-product Bernstein
coefficients (one small matmul per axis — the convex-hull property gives
``min c ≤ u ≤ max c`` on the element), then optionally tighten by ``nsub``
levels of de Casteljau dyadic subdivision, all as batched einsums over the
element axis.  Tensor-product geometries (segment/quad/hex)."""

from __future__ import annotations

from math import comb
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .basis import nodal_to_bernstein
from .build import restriction_for
from .geometry import DIMENSION


def _subdivision_matrices(p: int) -> Tuple[np.ndarray, np.ndarray]:
    """de Casteljau halves: c∘L gives the [0,½] piece, c∘R the [½,1]."""
    n = p + 1
    L = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            L[i, j] = comb(i, j) * 0.5 ** i
    R = L[::-1, ::-1]
    return L, R


def element_bounds(fes, u, nsub: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) per element with lo ≤ u_h ≤ hi guaranteed on the element.

    ``nsub`` dyadic subdivision levels tighten the bounds toward the true
    range (cost (2^nsub)^dim control nets per element)."""
    p = fes.order
    dim = DIMENSION[fes.mesh.geom]
    e = restriction_for(fes).mult(jnp.asarray(u))      # (ne, nd) lex lattice
    ne = e.shape[0]
    n1 = p + 1
    c = jnp.asarray(e).reshape((ne,) + (n1,) * dim)
    N = jnp.asarray(nodal_to_bernstein(p), c.dtype)
    for ax in range(dim):
        c = jnp.moveaxis(
            jnp.tensordot(N, jnp.moveaxis(c, 1 + ax, -1), axes=[[1], [-1]]),
            0, -1)
        c = jnp.moveaxis(c, -1, 1 + ax)

    L, R = _subdivision_matrices(p)
    LR = jnp.asarray(np.stack([L, R]), c.dtype)        # (2, n1, n1)

    pieces = c[:, None]                                # (ne, npiece, ...)
    for _ in range(nsub):
        for ax in range(dim):
            # split every piece along axis ax into its two halves
            pieces = jnp.moveaxis(pieces, 2 + ax, -1)
            halves = jnp.einsum("hij,...j->h...i", LR, pieces)
            pieces = jnp.concatenate([halves[0], halves[1]], axis=1)
            pieces = jnp.moveaxis(pieces, -1, 2 + ax)

    flat = pieces.reshape(ne, pieces.shape[1], -1)
    lo = jnp.min(jnp.min(flat, axis=-1), axis=-1)
    hi = jnp.max(jnp.max(flat, axis=-1), axis=-1)
    return np.asarray(lo), np.asarray(hi)
