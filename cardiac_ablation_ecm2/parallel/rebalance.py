"""Repartitioning / load rebalance for partitioned FE spaces.

Reference analog: ``ParNCMesh::Rebalance`` (``mesh/pncmesh.hpp``) and
``ParMesh`` redistribution — after AMR (or any cost change) elements migrate
so every rank carries equal work.

Design: partitions are *tables*, not distributed state — rebalancing is
(1) a new weighted-RCB partition from per-element costs, (2) a rebuilt
``ParFESpace``, and (3) a precomputed **transfer map** that moves stacked
device-local fields old→new in one device-side gather.  On a real multi-chip
mesh the flat gather lowers to an all-gather + local gather; there
is no peer-to-peer migration protocol to get wrong (SURVEY.md §2.5 design
note).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .partition import element_centroids, rcb_weighted
from .pfespace import ParFESpace, build


def repartition(pf: ParFESpace, weights: np.ndarray = None) -> ParFESpace:
    """New ParFESpace with element loads balanced by ``weights`` (default:
    uniform — useful when the previous partition was user-supplied/skewed)."""
    mesh = pf.fes.mesh
    if weights is None:
        weights = np.ones(mesh.ne)
    parts = rcb_weighted(element_centroids(mesh), weights, pf.ndev)
    return build(pf.fes, pf.ndev, parts)


@dataclasses.dataclass(eq=False)
class TransferMap:
    """Old stacked layout → new stacked layout field mover (jit-safe)."""

    idx: jnp.ndarray    # (ndev_new, nloc_new+1) flat indices into old stack
    mask: jnp.ndarray   # (ndev_new, nloc_new+1) 1 real / 0 pad+trash

    def __call__(self, u_loc_old: jnp.ndarray) -> jnp.ndarray:
        return u_loc_old.reshape(-1)[self.idx] * self.mask


def transfer_map(pf_old: ParFESpace, pf_new: ParFESpace) -> TransferMap:
    """Build the old→new gather map.  Requires both spaces to wrap the same
    FESpace (same global dof numbering); any old owner of a dof supplies its
    value (owners agree after a halo exchange)."""
    assert pf_old.fes is pf_new.fes or (
        pf_old.fes.ndof_scalar == pf_new.fes.ndof_scalar
    )
    stride_old = pf_old.nloc + 1
    owner_flat = np.zeros(pf_old.ndof_global, dtype=np.int64)
    for d in range(pf_old.ndev - 1, -1, -1):   # first owner wins
        g = pf_old.loc2glob[d]
        real = np.nonzero(g >= 0)[0]
        owner_flat[g[real]] = d * stride_old + real

    idx = np.zeros((pf_new.ndev, pf_new.nloc + 1), dtype=np.int64)
    mask = np.zeros((pf_new.ndev, pf_new.nloc + 1))
    for d in range(pf_new.ndev):
        g = pf_new.loc2glob[d]
        real = np.nonzero(g >= 0)[0]
        idx[d, real] = owner_flat[g[real]]
        mask[d, real] = 1.0
    return TransferMap(idx=jnp.asarray(idx), mask=jnp.asarray(mask))
