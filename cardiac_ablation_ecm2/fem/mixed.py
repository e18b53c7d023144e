"""Mixed-geometry meshes and FE spaces (SURVEY.md §7 hard-part 5).

Reference analog: MFEM's per-element-type ``Mesh`` containers and the
geometry-batched device kernels (one kernel launch per geometry class).
Design: a mixed mesh is a tuple of homogeneous **blocks** — one
(geometry, elements, attributes) batch per element type — and every op loops
over blocks and sums contributions into one shared L-vector:

    y = Σ_b Rᵀ_b apply_b(qdata_b, R_b x)

Conformity across blocks is automatic: the entity-key dof enumeration
(``fespace._elem_node_keys``) is geometry-agnostic, and H1 simplex bases
place their edge nodes at the same 1D GLL positions as the tensor elements
(``basis.h1_nodes``), so tri↔quad traces interpolate identical node sets.

Scope this round: 2D (tri + quad blocks) with segment boundaries; 3D mixed
blocks work through the same code path but mixed-shape *boundary* arrays are
deferred.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..mesh.mesh import Mesh
from ..utils.config import real_t
from .basis import make_dof_to_quad
from .fespace import _EDGE, _FACE, _KEYLEN, _VERT, _elem_node_keys
from .geometry import DIMENSION, Geometry, NUM_VERTS
from .geom_factors import compute_geometric_factors
from .quadinterp import device_basis, eval_values_t
from .restriction import ElementRestriction
from ..utils.native import encode_rows


@dataclasses.dataclass(eq=False)
class MixedMesh:
    """Mixed-geometry mesh: per-geometry element blocks over one vertex set."""

    vertices: np.ndarray                       # (nv, sdim)
    blocks: Tuple                              # ((geom, elements, attrs), …)
    boundary: np.ndarray                       # (nbe, 2) segments (2D)
    bdr_attributes: np.ndarray
    #: 3D: per-shape boundary face blocks ((geom, faces, attrs), …) —
    #: quad and tri faces of a mixed hex/wedge/pyramid/tet mesh
    boundary_blocks: Tuple = ()

    @property
    def nv(self) -> int:
        return len(self.vertices)

    @property
    def ne(self) -> int:
        return sum(len(b[1]) for b in self.blocks)

    @property
    def nbe(self) -> int:
        return len(self.boundary)

    @property
    def dim(self) -> int:
        return DIMENSION[self.blocks[0][0]]


def make_mixed_strip(n: int = 4) -> MixedMesh:
    """Unit square: left half quads, right half triangles (2n×n grid) —
    the tri/quad interface runs vertically through the middle."""
    from ..mesh.mesh import make_cartesian_2d

    h = make_cartesian_2d(2 * n, n)
    cent = h.vertices[h.elements].mean(axis=1)
    left = cent[:, 0] < 0.5
    quads = h.elements[left]
    qattr = h.attributes[left]
    tris = []
    tattr = []
    for t, a in zip(h.elements[~left], h.attributes[~left]):
        tris.append([t[0], t[1], t[2]])
        tris.append([t[0], t[2], t[3]])
        tattr += [a, a]
    return MixedMesh(
        vertices=h.vertices,
        blocks=(
            (Geometry.SQUARE, quads, qattr),
            (Geometry.TRIANGLE, np.array(tris, dtype=np.int64),
             np.array(tattr, dtype=np.int64)),
        ),
        boundary=h.boundary,
        bdr_attributes=h.bdr_attributes,
    )


@dataclasses.dataclass(eq=False)
class MixedFESpace:
    """H1 space over a MixedMesh: one conforming dof numbering shared by all
    geometry blocks (entity keys), per-block gather maps + restrictions."""

    mesh: MixedMesh
    order: int

    def __post_init__(self):
        p = self.order
        mesh = self.mesh
        keys_all = []
        offs = 0
        self._block_nd = []
        for (geom, elems, _a) in mesh.blocks:
            eids = np.arange(offs, offs + len(elems), dtype=np.int64)
            k = _elem_node_keys(geom, p, elems.astype(np.int64), eids)
            keys_all.append(k.reshape(-1, _KEYLEN))
            self._block_nd.append(k.shape[1])
            offs += len(elems)
        flat = np.concatenate(keys_all, axis=0)
        uniq, ids, _ = encode_rows(flat, None)
        self.ndof_scalar = int(uniq)
        self.gather_maps = []
        pos = 0
        for (geom, elems, _a), nd in zip(mesh.blocks, self._block_nd):
            cnt = len(elems) * nd
            self.gather_maps.append(
                ids[pos:pos + cnt].reshape(len(elems), nd).astype(np.int32)
            )
            pos += cnt
        self._keys_flat = flat
        self._ids = ids

        # per-block basis/geometry/restriction
        self.d2qs, self.gfs, self.dbs, self.restrictions = [], [], [], []
        for (geom, elems, _a), gm in zip(mesh.blocks, self.gather_maps):
            d2q = make_dof_to_quad(geom, p)
            # Q1/P1 geometry from corner vertices (straight elements)
            sub = Mesh(
                geom=geom,
                vertices=mesh.vertices,
                elements=elems.astype(np.int64),
                attributes=np.ones(len(elems), dtype=np.int64),
                boundary=np.zeros((0, 2), dtype=np.int64),
                bdr_attributes=np.zeros(0, dtype=np.int64),
            )
            from .fespace import element_node_coords

            X = element_node_coords(sub, p)
            self.d2qs.append(d2q)
            self.gfs.append(compute_geometric_factors(X, d2q))
            self.dbs.append(device_basis(d2q, str(real_t(None))))
            self.restrictions.append(
                ElementRestriction.from_map(gm, self.ndof_scalar)
            )

    @property
    def ndof(self) -> int:
        return self.ndof_scalar

    # ------------------------------------------------------------------
    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        mesh = self.mesh
        if mesh.boundary_blocks:                   # 3D mixed boundary
            bverts, bedges, bfaces = set(), set(), set()
            for (geom, faces, attrs) in mesh.boundary_blocks:
                if bdr_marker is None:
                    sel = np.ones(len(faces), dtype=bool)
                else:
                    sel = np.isin(attrs, np.asarray(list(bdr_marker)))
                for f in faces[sel]:
                    vs = [int(v) for v in f]
                    bverts.update(vs)
                    k = len(vs)
                    for i in range(k):
                        a, b = vs[i], vs[(i + 1) % k]
                        bedges.add((min(a, b), max(a, b)))
                    bfaces.add(tuple(sorted(vs)))
            keys = self._keys_flat
            etype = keys[:, 4] >> 48
            ess = set()
            for i in range(len(keys)):
                t = int(etype[i])
                if t == _VERT and int(keys[i, 0]) in bverts:
                    ess.add(int(self._ids[i]))
                elif t == _EDGE and (int(keys[i, 0]),
                                     int(keys[i, 1])) in bedges:
                    ess.add(int(self._ids[i]))
                elif t == _FACE:
                    fk = tuple(sorted(int(v) for v in keys[i, :4]
                               if v >= 0))
                    if fk in bfaces:
                        ess.add(int(self._ids[i]))
            return np.array(sorted(ess), dtype=np.int32)
        if bdr_marker is None:
            sel = np.ones(mesh.nbe, dtype=bool)
        else:
            sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        bsegs = mesh.boundary[sel]
        bverts = set(int(v) for v in bsegs.reshape(-1))
        bedges = set(
            (min(int(a), int(b)), max(int(a), int(b))) for (a, b) in bsegs
        )
        keys = self._keys_flat
        etype = keys[:, 4] >> 48
        ess = set()
        for i in range(len(keys)):
            t = int(etype[i])
            if t == _VERT and int(keys[i, 0]) in bverts:
                ess.add(int(self._ids[i]))
            elif t == _EDGE and (int(keys[i, 0]), int(keys[i, 1])) in bedges:
                ess.add(int(self._ids[i]))
        return np.array(sorted(ess), dtype=np.int32)

    @property
    def dof_coords(self) -> np.ndarray:
        out = np.zeros((self.ndof_scalar, self.mesh.vertices.shape[1]))
        from .fespace import element_node_coords

        for (geom, elems, _a), gm in zip(self.mesh.blocks, self.gather_maps):
            sub = Mesh(
                geom=geom, vertices=self.mesh.vertices,
                elements=elems.astype(np.int64),
                attributes=np.ones(len(elems), dtype=np.int64),
                boundary=np.zeros((0, 2), dtype=np.int64),
                bdr_attributes=np.zeros(0, dtype=np.int64),
            )
            X = element_node_coords(sub, self.order)
            out[gm.reshape(-1)] = X.reshape(-1, X.shape[-1])
        return out

    def project(self, f) -> jnp.ndarray:
        return jnp.asarray(f(self.dof_coords), real_t(None))


# ----------------------------------------------------------------------------
# mixed operators
# ----------------------------------------------------------------------------


class MixedPAOperator:
    """Σ_b Rᵀ_b apply_b(qdata_b, R_b x) with per-block integrator terms."""

    def __init__(self, fes: MixedFESpace, diffusion_coeff=None,
                 mass_coeff=None):
        from ..ops import diffusion as dmod
        from ..ops import mass as mmod

        self.fes = fes
        self.terms = []
        for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
            blk = []
            if diffusion_coeff is not None:
                blk.append(("diffusion", dmod,
                            dmod.setup(gf, diffusion_coeff)))
            if mass_coeff is not None:
                qd = mmod.setup(gf)
                if callable(mass_coeff):
                    qd = qd * jnp.asarray(mass_coeff(gf.x), qd.dtype)
                else:
                    qd = qd * mass_coeff
                blk.append(("mass", mmod, qd))
            self.terms.append((db, R, blk))

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        y = jnp.zeros_like(x)
        for db, R, blk in self.terms:
            e = R.mult(x)
            acc = None
            for (_n, mod, qd) in blk:
                t = mod.apply(db, qd, e)
                acc = t if acc is None else acc + t
            y = y + R.mult_transpose(acc)
        return y

    def diagonal(self) -> jnp.ndarray:
        d = jnp.zeros(self.fes.ndof_scalar, dtype=real_t(None))
        for db, R, blk in self.terms:
            acc = None
            for (_n, mod, qd) in blk:
                t = mod.diagonal(db, qd)
                acc = t if acc is None else acc + t
            d = d + R.mult_transpose(acc)
        return d


def mixed_domain_lf(fes: MixedFESpace, f) -> jnp.ndarray:
    b = jnp.zeros(fes.ndof_scalar, dtype=real_t(None))
    for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
        fq = jnp.asarray(f(np.asarray(gf.x)), real_t(None))
        b = b + R.mult_transpose(eval_values_t(db, gf.wdet * fq))
    return b


# ----------------------------------------------------------------------------
# 3D mixed mesh: hex region + tet region glued by pyramids
# ----------------------------------------------------------------------------


def make_mixed_cube(n: int = 2) -> MixedMesh:
    """Unit cube, 2n×n×n cells: left half hexes, right half tet/pyramid.

    Each right cell is split from its center: interface faces (adjacent to
    a hex) become pyramids, every other face is diagonal-split (min-vertex
    rule, so face views agree across cells) into two tets — the standard
    hex↔tet glue layer (reference: pyramids as transition elements,
    mesh/pyramid.hpp).  Boundary faces: quads on the hex side, triangles
    on the tet side (``boundary_blocks``)."""
    from ..fem.geometry import FACES
    from ..mesh.mesh import make_cartesian_3d

    h = make_cartesian_3d(2 * n, n, n)
    cent = h.vertices[h.elements].mean(axis=1)
    left = cent[:, 0] < 0.5
    verts = [v for v in h.vertices]

    hexes = h.elements[left]
    hattr = h.attributes[left]
    loc_faces = FACES[Geometry.CUBE]

    pyramids, pattr, tets, tattr = [], [], [], []
    tri_bdr, tri_battr = [], []

    # boundary face lookup (sorted quad key → attribute)
    bdr_map = {tuple(sorted(map(int, f))): int(a)
               for f, a in zip(h.boundary, h.bdr_attributes)}
    hex_face_keys = set()
    for t in hexes:
        for f in loc_faces:
            hex_face_keys.add(tuple(sorted(int(t[v]) for v in f)))

    def add_center(cell):
        verts.append(h.vertices[cell].mean(axis=0))
        return len(verts) - 1

    def tri_split(quad):
        """Split a cyclic quad across the diagonal at its min-id vertex."""
        r = int(np.argmin(quad))
        q = [quad[(r + k) % 4] for k in range(4)]
        return (q[0], q[1], q[2]), (q[0], q[2], q[3])

    for t, a in zip(h.elements[~left], h.attributes[~left]):
        c = add_center(t)
        for f in loc_faces:
            quad = [int(t[v]) for v in f]
            key = tuple(sorted(quad))
            if key in hex_face_keys:
                # interface: pyramid on the quad base
                b = list(quad)
                v0, v1, v3 = (np.asarray(verts[b[0]]), np.asarray(verts[b[1]]),
                              np.asarray(verts[b[3]]))
                nrm = np.cross(v1 - v0, v3 - v0)
                if np.dot(nrm, np.asarray(verts[c]) - v0) < 0:
                    b = [b[0], b[3], b[2], b[1]]
                pyramids.append(b + [c])
                pattr.append(a)
                continue
            battr = bdr_map.get(key)
            for tri in tri_split(quad):
                p0, p1, p2 = (np.asarray(verts[tri[0]]),
                              np.asarray(verts[tri[1]]),
                              np.asarray(verts[tri[2]]))
                tet = list(tri) + [c]
                if np.dot(np.cross(p1 - p0, p2 - p0),
                          np.asarray(verts[c]) - p0) < 0:
                    tet = [tri[0], tri[2], tri[1], c]
                tets.append(tet)
                tattr.append(a)
                if battr is not None:
                    tri_bdr.append(list(tri))
                    tri_battr.append(battr)

    # hex-side boundary quads (faces of kept hexes that are boundary)
    quad_bdr, quad_battr = [], []
    for f, a in zip(h.boundary, h.bdr_attributes):
        key = tuple(sorted(map(int, f)))
        if key in hex_face_keys:
            quad_bdr.append([int(v) for v in f])
            quad_battr.append(int(a))

    blocks = [(Geometry.CUBE, np.asarray(hexes, dtype=np.int64), hattr)]
    if pyramids:
        blocks.append((Geometry.PYRAMID,
                       np.array(pyramids, dtype=np.int64),
                       np.array(pattr, dtype=np.int64)))
    blocks.append((Geometry.TETRAHEDRON, np.array(tets, dtype=np.int64),
                   np.array(tattr, dtype=np.int64)))
    bblocks = []
    if quad_bdr:
        bblocks.append((Geometry.SQUARE,
                        np.array(quad_bdr, dtype=np.int64),
                        np.array(quad_battr, dtype=np.int64)))
    if tri_bdr:
        bblocks.append((Geometry.TRIANGLE,
                        np.array(tri_bdr, dtype=np.int64),
                        np.array(tri_battr, dtype=np.int64)))
    return MixedMesh(
        vertices=np.array(verts),
        blocks=tuple(blocks),
        boundary=np.zeros((0, 2), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
        boundary_blocks=tuple(bblocks),
    )
