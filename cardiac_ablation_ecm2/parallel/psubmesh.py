"""Parallel SubMesh + device-local transfer maps (ParSubMesh analog).

Reference analog: ``ParSubMesh::CreateFromDomain/CreateFromBoundary``
(``mesh/submesh/psubmesh.hpp:55``) + ``ParTransferMap``
(``mesh/submesh/ptransfermap.hpp``) — the parallel multidomain coupling
mechanism of ``miniapps/multidomain/multidomain.cpp:247-365``.

Design: the submesh inherits the parent's element partition
(each sub element lives on its parent element's device; boundary submeshes
live on the adjacent element's device).  Every sub-local dof is then
guaranteed to exist in the parent's device-local L-vector, so both
transfer directions are *pure per-device gathers/scatters inside
``shard_map`` — zero communication*.  Shared-dof consistency is preserved
because parent L-vectors are replicated-consistent after halo exchange and
``to_parent`` writes identical values on every device sharing a dof.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..fem.geometry import FACES
from ..mesh.submesh import SubMesh, create_transfer_map
from ..utils.config import index_t
from .pfespace import ParFESpace, build


def boundary_adjacent_elements(mesh) -> np.ndarray:
    """(nbe,) element adjacent to each boundary face (host-side, hashed)."""
    loc = FACES[mesh.geom]
    key2el = {}
    for e in range(mesh.ne):
        for f in loc:
            key2el[tuple(sorted(int(v) for v in mesh.elements[e, list(f)]))] \
                = e
    out = np.empty(mesh.nbe, dtype=np.int64)
    for i, b in enumerate(mesh.boundary):
        out[i] = key2el[tuple(sorted(int(v) for v in b))]
    return out


def sub_partition(parent_parts: np.ndarray, sm: SubMesh) -> np.ndarray:
    """Partition of the submesh inherited from the parent's."""
    if sm.from_boundary:
        adj = boundary_adjacent_elements(sm.parent)
        return parent_parts[adj[sm.parent_elems]]
    return parent_parts[sm.parent_elems]


@dataclasses.dataclass(eq=False)
class ParTransferMap:
    """Per-device dof map: sub local L-vector ↔ parent local L-vector.

    ``idx``/``wmask`` are stacked on a leading device axis; pass them
    through ``shard_map`` with the other per-device tables and use the
    module-level ``transfer_to_sub``/``transfer_to_parent`` on the device
    slabs.  ``to_sub`` is a pure gather (no collectives); ``to_parent``
    needs the parent's halo schedule for interface dofs shared with
    devices that hold no sub element (ParTransferMap's
    CommunicateSharedVertices analog, mesh/submesh/ptransfermap.cpp).
    """

    idx: jnp.ndarray              # (ndev, nloc_sub+1) parent-local ids
    wmask: jnp.ndarray            # (ndev, nloc_parent+1) 1 where written


def transfer_to_sub(idx_d: jnp.ndarray, u_parent_loc: jnp.ndarray):
    """Per-device: parent local L-vector → sub local L-vector (incl. trash
    slot)."""
    return u_parent_loc[idx_d]


def transfer_to_parent(idx_d: jnp.ndarray, u_sub_loc: jnp.ndarray,
                       u_parent_loc: jnp.ndarray, wmask_d=None,
                       send_idx_d=None, perms=None, nloc=None):
    """Per-device: write sub values into the parent local L-vector.

    The sub trash slot maps to the parent trash slot, so padded entries
    land harmlessly; real parent dofs not in the sub are unchanged.  With
    the parent halo schedule (``wmask_d``/``send_idx_d``/``perms``/
    ``nloc``), written values are broadcast to sharing devices whose own
    sub block does not touch the dof — required for cross-device
    consistency whenever the submesh interface crosses the partition.
    Every writer holds the identical final value, so the exchange is a
    bit-exact *select* (take a writing partner's value iff not written
    locally), not an average."""
    from jax import lax

    from .ops import AXIS

    up = u_parent_loc.at[idx_d].set(u_sub_loc)
    if wmask_d is None:
        return up
    w = wmask_d.at[nloc].set(0.0)
    for c, perm in enumerate(perms):
        if not perm:
            continue
        sl = send_idx_d[c]
        bu, bw = up[sl], w[sl]
        ru = lax.ppermute(bu, AXIS, perm)
        rw = lax.ppermute(bw, AXIS, perm)
        take = (bw == 0) & (rw > 0)
        up = up.at[sl].set(jnp.where(take, ru, bu))
        w = w.at[sl].set(jnp.maximum(bw, rw))
    return up.at[nloc].set(u_parent_loc[nloc])


def build_sub(parent_pf: ParFESpace, sm: SubMesh, sub_fes,
              parent_fes=None):
    """(sub ParFESpace, ParTransferMap) with the inherited partition.

    ``sub_fes`` — FESpace on ``sm.mesh`` with the parent's order;
    ``parent_fes`` defaults to ``parent_pf.fes``."""
    if parent_fes is None:
        parent_fes = parent_pf.fes
    parts_sub = sub_partition(parent_pf.parts, sm)
    sub_pf = build(sub_fes, parent_pf.ndev, parts_sub)

    s2p = np.asarray(
        create_transfer_map(parent_fes, sub_fes, sm).sub_to_parent)

    ndev = parent_pf.ndev
    idx = np.full((ndev, sub_pf.nloc + 1), parent_pf.nloc, dtype=np.int64)
    for d in range(ndev):
        gsub = sub_pf.loc2glob[d]                     # (nloc_sub,) or −1
        valid = gsub >= 0
        gpar = np.where(valid, s2p[np.clip(gsub, 0, len(s2p) - 1)], -1)
        ploc = np.searchsorted(
            np.where(parent_pf.loc2glob[d] < 0,
                     np.iinfo(np.int64).max, parent_pf.loc2glob[d]),
            np.clip(gpar, 0, None))
        ok = valid & (ploc < parent_pf.nloc) & (
            parent_pf.loc2glob[d][np.clip(ploc, 0, parent_pf.nloc - 1)]
            == gpar)
        if not bool(np.all(ok | ~valid)):
            missing = gsub[valid & ~ok]
            raise RuntimeError(
                f"device {d}: {len(missing)} sub dofs missing from the "
                "parent device block — partition not inherited?")
        idx[d, : sub_pf.nloc] = np.where(ok, ploc, parent_pf.nloc)

    wmask = np.zeros((ndev, parent_pf.nloc + 1))
    for d in range(ndev):
        real = idx[d, : sub_pf.nloc]
        wmask[d, real[real < parent_pf.nloc]] = 1.0
    return sub_pf, ParTransferMap(idx=jnp.asarray(idx, index_t()),
                                  wmask=jnp.asarray(wmask))
