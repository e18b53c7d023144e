"""Partitioned FE space: device-local numbering + halo-exchange tables.

Reference analog: ``ParFiniteElementSpace`` (``fem/pfespace.hpp:30``) — the
parallel prolongation/restriction pair built by ``Build_Dof_TrueDof_Matrix``
(``fem/pfespace.cpp:838``) and the neighbor-exchange machinery of
``GroupCommunicator`` (``general/communication.hpp:232``; Bcast = owner→ghost,
Reduce = ghost→owner).

Design (SURVEY.md §2.5): no owner/ghost asymmetry and no
matrix P.  Each device owns a *balanced* block of elements; its local
L-vector holds every dof its elements touch.  After a local E→L scatter,
shared dofs hold partial sums; a **symmetric pairwise halo exchange** adds
the partners' partials so every device ends with the full assembled value —
functionally Pᵀ followed by P (Reduce+Bcast) fused into one exchange.  The
exchange schedule is a greedy edge coloring of the device-sharing graph;
each color is a matching realized as one ``lax.ppermute`` between devices.

All tables are built host-side in numpy and stacked on a leading device
axis; ``shard_map`` splits them so each device sees only its own rows.
Padding conventions (static shapes everywhere):

* element slots beyond a device's real count replicate element 0 with
  ``elem_weight`` 0 (their qdata is zeroed, so they contribute nothing);
* the local L-vector has one extra trailing **trash slot**; every padded
  gather/scatter/halo index points there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..fem.fespace import FESpace, element_node_coords
from .partition import partition_mesh


@dataclasses.dataclass(eq=False)
class ParFESpace:
    """Stacked per-device arrays (leading axis = device)."""

    fes: FESpace
    ndev: int
    parts: np.ndarray            # (ne,) device of each element

    ne_loc: int                  # padded local element count
    nloc: int                    # padded local dof count (excl. trash slot)
    ncolors: int                 # halo exchange rounds
    max_shared: int              # padded shared-dof list length

    elems: np.ndarray            # (ndev, ne_loc) global element ids
    elem_weight: np.ndarray      # (ndev, ne_loc) 1 real / 0 pad
    gather: np.ndarray           # (ndev, ne_loc, nd) local dof ids (pad→nloc)
    scat_perm: np.ndarray        # (ndev, ne_loc*nd) E-slot sort permutation
    scat_seg: np.ndarray         # (ndev, ne_loc*nd) sorted local dof ids
    loc2glob: np.ndarray         # (ndev, nloc) global dof ids (pad −1)
    dof_weight: np.ndarray       # (ndev, nloc+1) 1/multiplicity (pad 0)
    send_idx: np.ndarray         # (ndev, ncolors, max_shared) local ids (pad nloc)
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]  # per color: ppermute pairs
    node_coords: np.ndarray      # (ndev, ne_loc, nd_geo, sdim) geometry E-vector

    @property
    def ndof_global(self) -> int:
        return self.fes.ndof_scalar


def build(fes: FESpace, ndev: int, parts: np.ndarray = None,
          extra_dofs: List[np.ndarray] = None) -> ParFESpace:
    """``extra_dofs`` (optional, per device): global dofs to include in the
    device's local set beyond those of its elements — ghost dofs for NC
    constraint masters (ParNCMesh's ghost layer analog).  They join the
    halo-exchange tables like any shared dof."""
    mesh = fes.mesh
    gm = fes.gather_map.astype(np.int64)           # (ne, nd)
    ne, nd = gm.shape
    if parts is None:
        parts = partition_mesh(mesh, ndev)

    dev_elems: List[np.ndarray] = [
        np.nonzero(parts == d)[0] for d in range(ndev)
    ]
    ne_loc = max(len(e) for e in dev_elems)

    elems = np.zeros((ndev, ne_loc), dtype=np.int64)
    elem_weight = np.zeros((ndev, ne_loc))
    for d, e in enumerate(dev_elems):
        elems[d, : len(e)] = e
        elem_weight[d, : len(e)] = 1.0
        if len(e) < ne_loc:
            elems[d, len(e):] = e[0] if len(e) else 0

    # local dof sets (from real elements only), sorted by global id
    gdofs = [np.unique(gm[e].reshape(-1)) for e in dev_elems]
    if extra_dofs is not None:
        gdofs = [
            np.unique(np.concatenate([g, np.asarray(x, dtype=np.int64)]))
            if len(x) else g
            for g, x in zip(gdofs, extra_dofs)
        ]
    nloc = max(len(g) for g in gdofs)

    loc2glob = np.full((ndev, nloc), -1, dtype=np.int64)
    gather = np.full((ndev, ne_loc, nd), nloc, dtype=np.int64)
    for d in range(ndev):
        g = gdofs[d]
        if len(g) == 0:          # device owns no elements (e.g. an
            continue             # inherited submesh partition) — all trash
        loc2glob[d, : len(g)] = g
        # map real elements' global dofs → local ids; padded elements' dofs
        # follow element 0 of the device (their weight is 0 so any target is
        # safe, but mapping keeps indices in range)
        local = np.searchsorted(g, gm[elems[d]])
        local = np.clip(local, 0, len(g) - 1)
        ok = g[local] == gm[elems[d]]
        gather[d] = np.where(ok, local, nloc)

    # scatter permutation per device (sorted segment-sum, trash = segment nloc)
    flat = gather.reshape(ndev, ne_loc * nd)
    scat_perm = np.argsort(flat, axis=1, kind="stable")
    scat_seg = np.take_along_axis(flat, scat_perm, axis=1)

    # multiplicity of each global dof across devices
    mult = np.zeros(fes.ndof_scalar, dtype=np.int64)
    for g in gdofs:
        mult[g] += 1
    dof_weight = np.zeros((ndev, nloc + 1))
    for d, g in enumerate(gdofs):
        dof_weight[d, : len(g)] = 1.0 / mult[g]

    # device-sharing edges and shared dof lists
    shared: dict = {}
    owner_lists = [set(g.tolist()) for g in gdofs]
    for d in range(ndev):
        for e in range(d + 1, ndev):
            common = np.array(
                sorted(owner_lists[d] & owner_lists[e]), dtype=np.int64
            )
            if len(common):
                shared[(d, e)] = common

    # greedy edge coloring (each color = a matching of the device graph)
    colors: List[List[Tuple[int, int]]] = []
    for edge in sorted(shared, key=lambda de: -len(shared[de])):
        placed = False
        for cls in colors:
            if all(edge[0] not in pr and edge[1] not in pr for pr in cls):
                cls.append(edge)
                placed = True
                break
        if not placed:
            colors.append([edge])
    ncolors = max(len(colors), 1)
    max_shared = max((len(v) for v in shared.values()), default=1)

    send_idx = np.full((ndev, ncolors, max_shared), nloc, dtype=np.int64)
    perms: List[Tuple[Tuple[int, int], ...]] = []
    for c, cls in enumerate(colors):
        pairs = []
        for (d, e) in cls:
            common = shared[(d, e)]
            li_d = np.searchsorted(gdofs[d], common)
            li_e = np.searchsorted(gdofs[e], common)
            send_idx[d, c, : len(common)] = li_d
            send_idx[e, c, : len(common)] = li_e
            pairs += [(d, e), (e, d)]
        perms.append(tuple(pairs))
    if not colors:
        perms.append(tuple())

    # geometry E-vector per device
    Xe = element_node_coords(mesh, fes.order)       # (ne, nd_geo, sdim)
    node_coords = Xe[elems]                          # (ndev, ne_loc, nd_geo, s)

    return ParFESpace(
        fes=fes, ndev=ndev, parts=parts,
        ne_loc=ne_loc, nloc=nloc, ncolors=ncolors, max_shared=max_shared,
        elems=elems, elem_weight=elem_weight,
        gather=gather.astype(np.int32),
        scat_perm=scat_perm.astype(np.int32),
        scat_seg=scat_seg.astype(np.int32),
        loc2glob=loc2glob,
        dof_weight=dof_weight,
        send_idx=send_idx.astype(np.int32),
        perms=tuple(perms),
        node_coords=node_coords,
    )


# ----------------------------------------------------------------------------
# host-side helpers for tests
# ----------------------------------------------------------------------------


def scatter_global(pf: ParFESpace, u_global: np.ndarray) -> np.ndarray:
    """Global L-vector → stacked local vectors (ndev, nloc+1)."""
    out = np.zeros((pf.ndev, pf.nloc + 1), dtype=np.asarray(u_global).dtype)
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        real = g >= 0
        out[d, : pf.nloc][real] = np.asarray(u_global)[g[real]]
    return out


def gather_global(pf: ParFESpace, u_loc: np.ndarray) -> np.ndarray:
    """Stacked local vectors → global L-vector (last writer wins; all owners
    agree after a halo exchange)."""
    u_loc = np.asarray(u_loc)
    out = np.zeros(pf.ndof_global, dtype=u_loc.dtype)
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        real = g >= 0
        out[g[real]] = u_loc[d, : pf.nloc][real]
    return out
