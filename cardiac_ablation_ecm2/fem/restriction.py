"""Element restriction: L-vector ↔ E-vector gather/scatter.

Reference analog: ``ElementRestriction`` (``fem/restriction.hpp:40``) with its
precomputed ``offsets/indices/gather_map`` arrays (``restriction.hpp:50-52``)
and atomic-free transpose.

Design:
* L→E is a plain JAX gather ``u[gather_map]``.
* E→L (transpose, scatter-add) uses a **sorted segment-sum**: a host-side
  precomputed permutation sorts E-slots by destination L-dof, and
  ``jax.ops.segment_sum(..., indices_are_sorted=True)`` accumulates.  This is
  deterministic by construction — the analog of the reference's atomic-free
  offset-based transpose (``fem/restriction.cpp``) and the determinism test
  ``tests/unit/fem/test_fa_determinism.cpp``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t


@dataclasses.dataclass(frozen=True)
class ElementRestriction:
    """Gather/scatter maps as device arrays. Built once per (space, subset)."""

    ndof: int                 # scalar L-vector length
    gather: jnp.ndarray       # (ne, nd) int32
    perm: jnp.ndarray         # (ne*nd,) E-slot permutation sorting by L-dof
    seg_ids: jnp.ndarray      # (ne*nd,) sorted destination L-dofs

    @staticmethod
    def from_map(gather_map: np.ndarray, ndof: int) -> "ElementRestriction":
        from ..utils.config import index_t
        from ..utils.native import counting_argsort

        flat = gather_map.reshape(-1).astype(np.int64)
        perm = counting_argsort(flat, int(ndof) + 1)
        seg = flat[perm]
        return ElementRestriction(
            ndof=int(ndof),
            gather=jnp.asarray(gather_map, dtype=index_t()),
            perm=jnp.asarray(perm, dtype=index_t()),
            seg_ids=jnp.asarray(seg, dtype=index_t()),
        )

    @staticmethod
    def for_space(fes) -> "ElementRestriction":
        return ElementRestriction.from_map(fes.gather_map, fes.ndof_scalar)

    # ------------------------------------------------------------------
    def mult(self, u: jnp.ndarray) -> jnp.ndarray:
        """L→E: (ndof, ...) → (ne, nd, ...)."""
        return u[self.gather]

    def mult_transpose(self, u_e: jnp.ndarray) -> jnp.ndarray:
        """E→L scatter-add: (ne, nd, ...) → (ndof, ...), deterministic."""
        ne, nd = self.gather.shape
        flat = u_e.reshape(ne * nd, *u_e.shape[2:])
        vals = flat[self.perm]
        return jax.ops.segment_sum(
            vals, self.seg_ids, num_segments=self.ndof, indices_are_sorted=True
        )

    def mult_t(self, u: jnp.ndarray) -> jnp.ndarray:
        """L→E in transposed (lane-major) layout: (ndof,) → (nd, ne).
        The layout the lane-major applies consume (ops/lanemajor.py)."""
        return self.mult(u).T

    def mult_transpose_t(self, u_eT: jnp.ndarray) -> jnp.ndarray:
        """E→L scatter-add from transposed layout: (nd, ne) → (ndof,)."""
        return self.mult_transpose(u_eT.T)

    def counts(self) -> jnp.ndarray:
        """Multiplicity of each L-dof (how many E-slots map to it)."""
        ne, nd = self.gather.shape
        ones = jnp.ones(ne * nd, dtype=jnp.int32)
        return jax.ops.segment_sum(
            ones, self.seg_ids, num_segments=self.ndof, indices_are_sorted=True
        )


jax.tree_util.register_pytree_node(
    ElementRestriction,
    lambda r: ((r.gather, r.perm, r.seg_ids), (r.ndof,)),
    lambda aux, ch: ElementRestriction(
        ndof=aux[0], gather=ch[0], perm=ch[1], seg_ids=ch[2]),
)
