"""Parallel uniform refinement + device-local solution transfer.

Reference analog: ``ParMesh::UniformRefinement`` + ``ParFiniteElementSpace``
update + ``ParGridFunction::Update`` (mesh/pmesh.cpp, fem/pfespace.cpp) —
refine in place and carry fields to the new space.

Design: children inherit their parent's device (child o of coarse
element e is fine element ``o·ne_c + e`` — the ``HTransfer`` ordering), so
prolongation is device-local interpolation (batched (nchild, nd, nd)
einsum) + the standard scatter/halo; no repartition communication at all.
Rebalancing, if desired afterwards, is ``parallel.rebalance``'s job.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..fem.fespace import FESpace
from ..fem.transfer import HTransfer
from ..utils.config import real_t
from . import ops as pops
from .pfespace import ParFESpace, build


@dataclasses.dataclass(eq=False)
class ParHTransfer:
    """Stacked per-device uniform-refinement transfer tables."""

    coarse: ParFESpace
    fine: ParFESpace
    I: jnp.ndarray                # (nchild, nd, nd) child interpolation
    child_slot: jnp.ndarray      # (ndev, nchild, ne_loc_c) fine elem slot

    def prolongate_local(self, d_tables, uc_loc):
        """Per-device (inside shard_map): coarse local L → fine local L.

        ``d_tables`` = (gather_c, child_slot, gather_f_all, pm_f, sg_f,
        sd_f) device slabs; returns the fine local L-vector (consistent
        across devices after the embedded halo exchange)."""
        (g_c, cs, g_f, pm_f, sg_f, sd_f) = d_tables
        e_c = uc_loc[g_c]                              # (ne_loc_c, nd)
        e_ch = jnp.einsum("omn,en->oem", self.I, e_c)  # (nchild, ne_c, nd)
        ne_f = g_f.shape[0]
        nd = e_ch.shape[-1]
        e_f = jnp.zeros((ne_f + 1, nd), e_ch.dtype)
        e_f = e_f.at[cs.reshape(-1)].set(e_ch.reshape(-1, nd))
        # written-slot mask: padded/empty fine slots must not dilute counts
        wm = jnp.zeros(ne_f + 1, e_ch.dtype).at[cs.reshape(-1)].set(1.0)
        nloc_f = self.fine.nloc
        y = pops.local_scatter(e_f[:ne_f], pm_f, sg_f, nloc_f)
        y = pops.halo_sum(y, sd_f, self.fine.perms, nloc_f)
        cnt = pops.local_scatter(
            jnp.broadcast_to(wm[:ne_f, None], (ne_f, nd)), pm_f, sg_f,
            nloc_f)
        cnt = pops.halo_sum(cnt, sd_f, self.fine.perms, nloc_f)
        return jnp.where(cnt > 0, y / jnp.maximum(cnt, 1.0), 0.0)


def refine_uniform(pf: ParFESpace, dtype=None):
    """(fine ParFESpace, ParHTransfer): refine every element 2^dim-ways
    with children pinned to the parent's device."""
    rt = real_t(dtype)
    fes_c = pf.fes
    mesh_f = fes_c.mesh.uniform_refinement()
    fes_f = FESpace(mesh_f, fes_c.order)
    ne_c = fes_c.mesh.ne
    nchild = mesh_f.ne // ne_c
    # child o of parent e is fine element o*ne_c + e (HTransfer order)
    parts_f = np.tile(pf.parts, nchild)
    pf_f = build(fes_f, pf.ndev, parts_f)

    ht = HTransfer(fes_c, fes_f, dtype=dtype)

    # device-local slot of each child: position of global fine id in the
    # device's ascending element list (pad slots → trash row ne_loc_f)
    child_slot = np.full((pf.ndev, nchild, pf.ne_loc), pf_f.ne_loc,
                         dtype=np.int64)
    for d in range(pf.ndev):
        felems = pf_f.elems[d]
        order = np.argsort(felems, kind="stable")
        sorted_f = felems[order]
        real_c = pf.elem_weight[d] > 0
        for o in range(nchild):
            gids = o * ne_c + pf.elems[d]
            pos = np.searchsorted(sorted_f, gids)
            pos = np.clip(pos, 0, len(sorted_f) - 1)
            ok = (sorted_f[pos] == gids) & real_c
            child_slot[d, o] = np.where(ok, order[pos], pf_f.ne_loc)

    return pf_f, ParHTransfer(
        coarse=pf, fine=pf_f, I=jnp.asarray(np.asarray(ht.I), rt),
        child_slot=jnp.asarray(child_slot))
