"""Cross-device point evaluation on sharded fields (ParGridFunction +
FindPointsGSLIB redistribution analog).

Reference analog: ``FindPointsGSLIB`` on a ParMesh (``fem/gslib.hpp:122``)
— every rank submits arbitrary physical points; gslib routes each point to
the rank owning the containing element, interpolates there, and returns
the value to the requester.

Design: location (kd-tree + Newton inversion) is host-side setup, as
in the serial path.  The *redistribution* is the device part: each point
is assigned to its owner device with a padded per-device point table; one
``shard_map`` region interpolates device-locally from the device's local
L-vector and a ``psum`` returns every value to all devices (the SPMD
equivalent of gslib's return routing — each requester reads its own
points' slots from the replicated result)."""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..fem.faces import _eval_volume_basis
from ..mesh.point_eval import locate_points
from ..utils.config import index_t, real_t
from . import ops as pops
from .pfespace import ParFESpace


@dataclasses.dataclass(eq=False)
class ParPointEval:
    """Prepared interpolation tables for a fixed point set."""

    pf: ParFESpace
    npts: int
    B: jnp.ndarray                # (ndev, npt_loc, nd) basis at ref coords
    slot: jnp.ndarray             # (ndev, npt_loc) local element slot
    out_idx: jnp.ndarray          # (ndev, npt_loc) position in global output
    found: np.ndarray             # (npts,) bool

    def interpolate(self, u_loc_d, B_d, slot_d, out_idx_d, gather_d):
        """Per-device (inside shard_map): local L-vector → (npts,) values;
        a psum replicates the full result on every device."""
        e = u_loc_d[gather_d]                         # (ne_loc, nd)
        ept = e[slot_d]                               # (npt_loc, nd)
        vals = jnp.sum(B_d * ept, axis=1)
        out = jnp.zeros(self.npts + 1, vals.dtype).at[out_idx_d].add(vals)
        return lax.psum(out[: self.npts], pops.AXIS)


def prepare(pf: ParFESpace, pts: np.ndarray, dtype=None) -> ParPointEval:
    """Locate points host-side and build the per-device routing tables.

    Each found point is assigned to exactly one device owning its
    containing element (the element's partition device)."""
    rt = real_t(dtype)
    fes = pf.fes
    mesh = fes.mesh
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    elem, ref = locate_points(mesh, pts)
    found = elem >= 0
    npts = len(pts)

    owner = np.where(found, pf.parts[np.clip(elem, 0, mesh.ne - 1)], -1)
    # local element slot of each point's element on its owner device
    rows = [np.nonzero(owner == d)[0] for d in range(pf.ndev)]
    npt_loc = max((len(r) for r in rows), default=1)
    npt_loc = max(npt_loc, 1)
    nd = fes.gather_map.shape[1]
    B = np.zeros((pf.ndev, npt_loc, nd))
    slot = np.zeros((pf.ndev, npt_loc), dtype=np.int64)
    out_idx = np.full((pf.ndev, npt_loc), npts, dtype=np.int64)
    for d in range(pf.ndev):
        r = rows[d]
        if not len(r):
            continue
        B[d, : len(r)] = _eval_volume_basis(mesh.geom, fes.order, ref[r])
        # element slot on the device: position in the ascending element list
        felems = pf.elems[d]
        order = np.argsort(felems, kind="stable")
        pos = np.searchsorted(felems[order], elem[r])
        slot[d, : len(r)] = order[np.clip(pos, 0, len(felems) - 1)]
        out_idx[d, : len(r)] = r
    return ParPointEval(
        pf=pf, npts=npts, B=jnp.asarray(B, rt),
        slot=jnp.asarray(slot, index_t()),
        out_idx=jnp.asarray(out_idx, index_t()), found=found)


def interpolate_sharded(pe: ParPointEval, u_global: np.ndarray,
                        devices=None) -> np.ndarray:
    """Convenience driver: scatter a global field and run the sharded
    interpolation end-to-end (tests / host probes)."""
    from .pfespace import scatter_global

    pf = pe.pf
    if devices is None:
        devices = jax.devices()
    dmesh = DeviceMesh(np.array(devices[: pf.ndev]), (pops.AXIS,))
    u_loc = jnp.asarray(scatter_global(pf, np.asarray(u_global)))
    gth = jnp.asarray(pf.gather)

    @partial(shard_map, mesh=dmesh, in_specs=(P(pops.AXIS),) * 5,
             out_specs=P(pops.AXIS), check_vma=False)
    def go(ul, Bd, sl, oi, g):
        return pe.interpolate(ul[0], Bd[0], sl[0], oi[0], g[0])[None]

    vals = go(u_loc, pe.B, pe.slot, pe.out_idx, gth)
    return np.asarray(vals)[0]
