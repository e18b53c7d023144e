"""SubMesh extraction and parent↔sub field transfer.

Reference analog: ``SubMesh::CreateFromDomain/CreateFromBoundary`` +
``TransferMap::Transfer`` (``mesh/submesh/``, SURVEY.md §2.3) — the
multiphysics coupling mechanism used by ``miniapps/multidomain``.

Design: a submesh is just another element-batched Mesh; the transfer map
is a dof index array built by matching (sub element, local node) to
(parent element, local node) — transfers are single gathers/scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t
from .mesh import Mesh


@dataclasses.dataclass(eq=False)
class SubMesh:
    mesh: Mesh                   # the extracted submesh
    parent: Mesh
    parent_elems: np.ndarray     # (ne_sub,) parent element (domain submesh)
    from_boundary: bool = False  # True: parent_elems indexes parent.boundary


def create_from_domain(parent: Mesh, attributes: Sequence[int]) -> SubMesh:
    """Extract the subdomain with the given element attributes."""
    sel = np.isin(parent.attributes, np.asarray(list(attributes)))
    elems = parent.elements[sel]
    parent_ids = np.nonzero(sel)[0]
    used = np.unique(elems)
    remap = -np.ones(parent.nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    new_elems = remap[elems]
    # boundary of the submesh: faces appearing once (interface + outer)
    from collections import Counter

    from ..fem.geometry import FACES

    faces = Counter()
    rep = {}                     # sorted key → properly ordered face cycle
    loc = FACES[parent.geom]
    for t in new_elems:
        for f in loc:
            cyc = [int(t[v]) for v in f]
            key = tuple(sorted(cyc))
            faces[key] += 1
            rep.setdefault(key, cyc)   # keep a valid cyclic ordering
    bdr = [rep[f] for f, c in faces.items() if c == 1]
    # inherit parent's boundary attributes where faces coincide; interface
    # faces get a fresh attribute max+1 (SubMesh convention: new attribute)
    parent_bdr = {
        tuple(sorted(remap[b].tolist())): a
        for b, a in zip(parent.boundary, parent.bdr_attributes)
        if np.all(remap[b] >= 0)
    }
    new_attr = int(parent.bdr_attributes.max()) + 1 if parent.nbe else 1
    battr = [parent_bdr.get(tuple(sorted(f)), new_attr) for f in bdr]

    sub = Mesh(
        geom=parent.geom,
        vertices=parent.vertices[used],
        elements=new_elems,
        attributes=parent.attributes[sel],
        boundary=np.array(bdr, dtype=np.int64) if bdr else
        np.zeros((0, len(loc[0])), dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )
    return SubMesh(mesh=sub, parent=parent, parent_elems=parent_ids)


def create_from_boundary(parent: Mesh, attributes: Sequence[int]) -> SubMesh:
    """Extract marked boundary faces as a lower-dimensional mesh."""
    sel = np.isin(parent.bdr_attributes, np.asarray(list(attributes)))
    faces = parent.boundary[sel]
    parent_ids = np.nonzero(sel)[0]
    used = np.unique(faces)
    remap = -np.ones(parent.nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    bgeom = parent.bdr_geom
    sub = Mesh(
        geom=bgeom,
        vertices=parent.vertices[used],
        elements=remap[faces],
        attributes=parent.bdr_attributes[sel],
        boundary=np.zeros((0, 2), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
    )
    return SubMesh(
        mesh=sub, parent=parent, parent_elems=parent_ids, from_boundary=True
    )


@dataclasses.dataclass(eq=False)
class TransferMap:
    """Dof map between a parent FESpace and a submesh FESpace
    (TransferMap::Transfer analog)."""

    sub_to_parent: jnp.ndarray    # (ndof_sub,) parent dof of each sub dof

    def to_sub(self, u_parent: jnp.ndarray) -> jnp.ndarray:
        return u_parent[self.sub_to_parent]

    def to_parent(self, u_sub: jnp.ndarray, u_parent: jnp.ndarray) -> jnp.ndarray:
        """Write sub values into the parent field (other dofs unchanged)."""
        return u_parent.at[self.sub_to_parent].set(u_sub)


def create_transfer_map(parent_fes, sub_fes, sm: SubMesh) -> TransferMap:
    assert parent_fes.order == sub_fes.order
    if sm.from_boundary:
        pg = parent_fes.bdr_gather_map[sm.parent_elems]     # (ne_sub, ndf)
    else:
        pg = parent_fes.gather_map[sm.parent_elems]         # (ne_sub, nd)
    sg = sub_fes.gather_map                                  # (ne_sub, nd)
    # local node orderings agree iff local vertex order is preserved by the
    # extraction (it is: connectivity is copied row-wise), BUT the key-based
    # numbering canonicalizes via *global vertex ids* which the remap changes
    # order-preservingly (np.unique is monotone) — so edge/face canonical
    # frames agree and node n of sub element e IS node n of parent element.
    ndof_sub = sub_fes.ndof_scalar
    s2p = np.zeros(ndof_sub, dtype=np.int64)
    s2p[sg.reshape(-1)] = pg.reshape(-1)
    return TransferMap(sub_to_parent=jnp.asarray(s2p, index_t()))
