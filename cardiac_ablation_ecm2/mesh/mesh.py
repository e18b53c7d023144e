"""Unstructured mesh as element-batched index arrays.

Reference analog: ``mesh/mesh.hpp:64`` (``Mesh``) with its ``elements``,
``vertices``, ``boundary`` arrays (``mesh/mesh.hpp:102-108``), Cartesian
constructors ``MakeCartesian{2,3}D`` and ``UniformRefinement``
(``mesh/mesh.hpp:2433``).

Design: a mesh is an immutable plain-old-data bag of numpy arrays —
no per-element objects, one geometry type per mesh; mixed meshes are
per-geometry batched blocks (``fem/mixed.py``).  All construction/refinement runs
host-side in numpy (setup path); only dof-mapped arrays derived from the mesh
are shipped to device.

Curved (high-order) geometry uses the ``nodes`` field — an (ne, nd_el, sdim)
E-vector of geometry nodes in lexicographic local ordering (the analog of the
reference's nodal GridFunction, ``mesh/mesh.hpp:2367``).  When ``nodes`` is
None the geometry is the Q1/P1 multilinear map from ``vertices``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..fem.geometry import (
    DIMENSION,
    EDGES,
    FACES,
    FACE_GEOM,
    Geometry,
    IS_TENSOR,
    NUM_VERTS,
    REF_VERTS,
)


@dataclasses.dataclass
class Mesh:
    geom: Geometry
    vertices: np.ndarray        # (nv, sdim) float64
    elements: np.ndarray        # (ne, nv_el) int64
    attributes: np.ndarray      # (ne,) int64
    boundary: np.ndarray        # (nbe, nv_face) int64
    bdr_attributes: np.ndarray  # (nbe,) int64
    nodes: Optional[np.ndarray] = None   # (ne, nd_el, sdim) curved geometry
    nodes_order: int = 1

    @property
    def dim(self) -> int:
        return DIMENSION[self.geom]

    @property
    def sdim(self) -> int:
        return self.vertices.shape[1]

    @property
    def ne(self) -> int:
        return self.elements.shape[0]

    @property
    def nv(self) -> int:
        return self.vertices.shape[0]

    @property
    def nbe(self) -> int:
        return self.boundary.shape[0]

    @property
    def bdr_geom(self) -> Geometry:
        return FACE_GEOM[self.geom]

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.elements = np.asarray(self.elements, dtype=np.int64)
        self.attributes = np.asarray(self.attributes, dtype=np.int64)
        self.boundary = np.asarray(self.boundary, dtype=np.int64).reshape(
            -1, NUM_VERTS[self.bdr_geom] if self.dim > 0 else 0
        )
        self.bdr_attributes = np.asarray(self.bdr_attributes, dtype=np.int64)

    # ------------------------------------------------------------------
    def uniform_refinement(self, iterations: int = 1) -> "Mesh":
        """Refine every element 2^dim-ways (mesh/mesh.hpp:2433 analog)."""
        m = self
        for _ in range(iterations):
            m = _uniform_refine(m)
        return m


# ----------------------------------------------------------------------------
# Cartesian constructors (mesh/mesh.hpp MakeCartesian2D/3D analogs)
# ----------------------------------------------------------------------------


def make_cartesian_2d(nx: int, ny: int, sx: float = 1.0, sy: float = 1.0) -> Mesh:
    """Quadrilateral grid on [0,sx]×[0,sy].

    Boundary attributes follow the reference convention: 1=bottom, 2=right,
    3=top, 4=left.
    """
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)

    def vid(i, j):
        return i + (nx + 1) * j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(order="F"), J.ravel(order="F")
    elems = np.stack(
        [vid(I, J), vid(I + 1, J), vid(I + 1, J + 1), vid(I, J + 1)], axis=1
    )

    bdr, battr = [], []
    for i in range(nx):  # bottom / top
        bdr.append((vid(i, 0), vid(i + 1, 0))); battr.append(1)
        bdr.append((vid(i + 1, ny), vid(i, ny))); battr.append(3)
    for j in range(ny):  # right / left
        bdr.append((vid(nx, j), vid(nx, j + 1))); battr.append(2)
        bdr.append((vid(0, j + 1), vid(0, j))); battr.append(4)

    return Mesh(
        geom=Geometry.SQUARE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )


def make_cartesian_3d(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Hexahedral grid on [0,sx]×[0,sy]×[0,sz].

    Boundary attributes (reference convention, mesh/mesh.cpp Make3D):
    1=z=0, 2=y=0, 3=x=sx, 4=y=sy, 5=x=0, 6=z=sz.
    """
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack(
        [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
    )

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(order="F"), J.ravel(order="F"), K.ravel(order="F")
    elems = np.stack(
        [
            vid(I, J, K),
            vid(I + 1, J, K),
            vid(I + 1, J + 1, K),
            vid(I, J + 1, K),
            vid(I, J, K + 1),
            vid(I + 1, J, K + 1),
            vid(I + 1, J + 1, K + 1),
            vid(I, J + 1, K + 1),
        ],
        axis=1,
    )

    bdr, battr = [], []
    for j in range(ny):
        for i in range(nx):
            bdr.append((vid(i, j + 1, 0), vid(i + 1, j + 1, 0),
                        vid(i + 1, j, 0), vid(i, j, 0))); battr.append(1)
            bdr.append((vid(i, j, nz), vid(i + 1, j, nz),
                        vid(i + 1, j + 1, nz), vid(i, j + 1, nz))); battr.append(6)
    for k in range(nz):
        for i in range(nx):
            bdr.append((vid(i, 0, k), vid(i + 1, 0, k),
                        vid(i + 1, 0, k + 1), vid(i, 0, k + 1))); battr.append(2)
            bdr.append((vid(i + 1, ny, k), vid(i, ny, k),
                        vid(i, ny, k + 1), vid(i + 1, ny, k + 1))); battr.append(4)
    for k in range(nz):
        for j in range(ny):
            bdr.append((vid(nx, j, k), vid(nx, j + 1, k),
                        vid(nx, j + 1, k + 1), vid(nx, j, k + 1))); battr.append(3)
            bdr.append((vid(0, j + 1, k), vid(0, j, k),
                        vid(0, j, k + 1), vid(0, j + 1, k + 1))); battr.append(5)

    return Mesh(
        geom=Geometry.CUBE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )


def make_periodic_cartesian_2d(nx: int, ny: int, sx: float = 1.0,
                               sy: float = 1.0, periodic=(True, True)) -> Mesh:
    """Periodic quad grid: vertices on periodic boundaries are identified
    (the reference's MakePeriodic, mesh/mesh.cpp).  The key-based dof
    numbering and face matching then yield periodic continuity for free —
    periodic "boundary" faces pair up as interior faces.

    Vertex positions keep the left/bottom copy; element geometry for wrapped
    cells is supplied via explicit curved ``nodes`` so Jacobians stay correct.
    """
    from ..fem.geometry import REF_VERTS

    px, py = periodic
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)

    def vid(i, j):
        ii = i % nx if px else i
        jj = j % ny if py else j
        return ii + (nx + (0 if px else 1)) * jj

    nvx = nx if px else nx + 1
    nvy = ny if py else ny + 1
    X, Y = np.meshgrid(xs[:nvx], ys[:nvy], indexing="ij")
    verts = np.stack([X.ravel(order="F"), Y.ravel(order="F")], axis=1)

    elems = []
    nodes = []
    for j in range(ny):
        for i in range(nx):
            conn = [vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
            elems.append(conn)
            # physical corner coords of THIS cell (not the wrapped copies)
            corners = np.array([
                [xs[i], ys[j]], [xs[i + 1], ys[j]],
                [xs[i + 1], ys[j + 1]], [xs[i], ys[j + 1]],
            ])
            nodes.append(corners)
    elems = np.array(elems, dtype=np.int64)
    nodes = np.array(nodes)                  # (ne, 4, 2) = order-1 E-vector
    # reorder corner storage to the order-1 lex lattice (v0,v1,v3,v2)
    nodes = nodes[:, [0, 1, 3, 2], :]

    bdr, battr = [], []
    if not py:
        for i in range(nx):
            bdr.append((vid(i, 0), vid(i + 1, 0))); battr.append(1)
            bdr.append((vid(i + 1, ny), vid(i, ny))); battr.append(3)
    if not px:
        for j in range(ny):
            bdr.append((vid(nx, j), vid(nx, j + 1))); battr.append(2)
            bdr.append((vid(0, j + 1), vid(0, j))); battr.append(4)

    return Mesh(
        geom=Geometry.SQUARE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=(np.array(bdr, dtype=np.int64) if bdr
                  else np.zeros((0, 2), dtype=np.int64)),
        bdr_attributes=np.array(battr, dtype=np.int64),
        nodes=nodes,
        nodes_order=1,
    )


def make_cartesian_2d_tri(nx: int, ny: int, sx: float = 1.0, sy: float = 1.0) -> Mesh:
    """Triangular grid: each Cartesian quad split along its (v0,v2) diagonal."""
    q = make_cartesian_2d(nx, ny, sx, sy)
    e = q.elements
    tris = np.concatenate([e[:, [0, 1, 2]], e[:, [0, 2, 3]]], axis=0)
    attrs = np.concatenate([q.attributes, q.attributes])
    return Mesh(
        geom=Geometry.TRIANGLE,
        vertices=q.vertices,
        elements=tris,
        attributes=attrs,
        boundary=q.boundary,
        bdr_attributes=q.bdr_attributes,
    )


def make_cartesian_3d_tet(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Tetrahedral grid: each hex split into 6 tets around the (v0,v6) diagonal."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    e = h.elements
    # six tets sharing edge v0-v6; faces of the hex are split consistently
    # because every quad face is cut along the diagonal containing its
    # lowest-index corner of the pattern below.
    paths = [
        (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
    ]
    tets = np.concatenate([e[:, list(p)] for p in paths], axis=0)
    attrs = np.tile(h.attributes, 6)
    # boundary quads → 2 triangles, split along whichever diagonal the tet
    # decomposition actually cut the face with (per-face it alternates)
    tet_faces = set()
    loc_tet_faces = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]
    for f in loc_tet_faces:
        for row in tets[:, list(f)]:
            tet_faces.add(tuple(sorted(row)))
    btris = []
    battr = []
    for quad, attr in zip(h.boundary, h.bdr_attributes):
        q0, q1, q2, q3 = quad
        if tuple(sorted((q0, q1, q2))) in tet_faces:
            btris += [(q0, q1, q2), (q0, q2, q3)]
        else:
            btris += [(q0, q1, q3), (q1, q2, q3)]
        battr += [attr, attr]
    btris = np.array(btris, dtype=np.int64)
    battr = np.array(battr, dtype=np.int64)
    return Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=h.vertices,
        elements=tets,
        attributes=attrs,
        boundary=btris,
        bdr_attributes=battr,
    )


def make_cartesian_3d_prism(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Wedge (prism) grid: each hex split into 2 wedges by the v0–v2 bottom
    diagonal (consistent across columns, so all interior faces match).

    Boundary: the four *side* walls (quads).  The z=0/z=1 faces would be
    triangles — mixed-shape boundary arrays are a round-2 item — so they are
    left unlisted (natural/Neumann).  Use manufactured solutions with zero
    normal flux there, or constrain via ``essential_dofs`` of a SubMesh.
    """
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    e = h.elements
    w1 = e[:, [0, 1, 2, 4, 5, 6]]
    w2 = e[:, [0, 2, 3, 4, 6, 7]]
    wedges = np.concatenate([w1, w2], axis=0)
    attrs = np.tile(h.attributes, 2)
    V = h.vertices
    keep, battr = [], []
    for quad, attr in zip(h.boundary, h.bdr_attributes):
        z = V[quad, 2]
        if np.allclose(z, z[0]):
            continue                      # z-face (would split into tris)
        keep.append(tuple(int(v) for v in quad))
        battr.append(attr)
    return Mesh(
        geom=Geometry.PRISM,
        vertices=V,
        elements=wedges,
        attributes=attrs,
        boundary=np.array(keep, dtype=np.int64).reshape(-1, 4),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )


def make_cartesian_3d_pyramid(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Pyramid grid: each hex split into 6 pyramids with apex at the hex
    center (every boundary face stays a quad — the pyramid base)."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    from ..fem.geometry import FACES as _FACES

    centers = h.vertices[h.elements].mean(axis=1)         # (ne, 3)
    verts = np.concatenate([h.vertices, centers], axis=0)
    apex = h.nv + np.arange(h.ne)
    pyrs, attrs = [], []
    for e in range(h.ne):
        t = h.elements[e]
        for fverts in _FACES[Geometry.CUBE]:
            # FACES lists are outward-cyclic; viewed from the apex (inside)
            # that is clockwise — reverse for a positively-oriented pyramid
            base = [int(t[i]) for i in reversed(fverts)]
            pyrs.append(base + [int(apex[e])])
            attrs.append(h.attributes[e])
    return Mesh(
        geom=Geometry.PYRAMID,
        vertices=verts,
        elements=np.array(pyrs, dtype=np.int64),
        attributes=np.array(attrs, dtype=np.int64),
        boundary=h.boundary,
        bdr_attributes=h.bdr_attributes,
    )


def curve_mesh(mesh: Mesh, mapping, order: int) -> Mesh:
    """Isoparametric curved mesh: apply an analytic map to the order-p
    geometry lattice (the reference's SetCurvature + Transform pattern,
    mesh/mesh.hpp:2399).  ``mapping(x) -> x'`` acts on (..., sdim) arrays."""
    from ..fem.fespace import element_node_coords

    X = element_node_coords(mesh, order)            # (ne, nd, sdim) straight
    Xc = np.asarray(mapping(X))
    return Mesh(
        geom=mesh.geom,
        vertices=np.asarray(mapping(mesh.vertices)),
        elements=mesh.elements,
        attributes=mesh.attributes,
        boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes,
        nodes=Xc,
        nodes_order=order,
    )


# ----------------------------------------------------------------------------
# Entity tables
# ----------------------------------------------------------------------------


def unique_edges(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Unique mesh edges. Returns (edges (nedge, 2) sorted pairs,
    elem_edge (ne, n_loc_edges) edge ids)."""
    loc = np.array(EDGES[mesh.geom], dtype=np.int64)
    ev = mesh.elements[:, loc]                      # (ne, nle, 2)
    ev_sorted = np.sort(ev, axis=2)
    flat = ev_sorted.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return uniq, inv.reshape(mesh.ne, len(loc))


def unique_faces(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Unique mesh faces (3D). Returns (faces (nface, fv) as sorted vertex
    tuples, elem_face (ne, n_loc_faces)).

    Mixed-arity geometries (the wedge's 2 tris + 3 quads): keys are
    left-padded with −1 to the widest face, so tri and quad faces coexist
    in one table without colliding."""
    loc_list = FACES[mesh.geom]
    w = max(len(f) for f in loc_list)
    keys = []
    for f in loc_list:
        s = np.sort(mesh.elements[:, list(f)], axis=1)
        if s.shape[1] < w:
            pad = np.full((len(s), w - s.shape[1]), -1, dtype=s.dtype)
            s = np.concatenate([pad, s], axis=1)
        keys.append(s)
    flat = np.stack(keys, axis=1).reshape(-1, w)    # (ne·nlf, w)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    return uniq, inv.reshape(mesh.ne, len(loc_list))


# ----------------------------------------------------------------------------
# Uniform refinement (tensor geometries + triangles)
# ----------------------------------------------------------------------------


def _uniform_refine(mesh: Mesh) -> Mesh:
    if mesh.nodes is not None:
        return _refine_curved(mesh)
    if mesh.geom == Geometry.TRIANGLE:
        return _refine_tri(mesh)
    if mesh.geom not in (Geometry.SQUARE, Geometry.CUBE, Geometry.SEGMENT):
        raise NotImplementedError(f"refinement for {mesh.geom}")
    dim = mesh.dim

    # Lattice positions on the 2x-refined reference grid (coords in {0,1,2}).
    # Every lattice point is a parent corner / edge midpoint / face center /
    # cell center; assign global vertex ids per category.
    nv_old = mesh.nv
    new_verts = [mesh.vertices]
    vert_of: Dict[Tuple[int, ...], np.ndarray] = {}

    # corners
    ref = (REF_VERTS[mesh.geom] * 2).astype(np.int64)   # (nv_el, dim)
    for v_local, latt in enumerate(ref):
        vert_of[tuple(latt)] = mesh.elements[:, v_local]

    # edge midpoints
    edges, elem_edge = unique_edges(mesh)
    edge_mid = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
    new_verts.append(edge_mid)
    loc_edges = np.array(EDGES[mesh.geom], dtype=np.int64)
    for le, (a, b) in enumerate(loc_edges):
        latt = tuple(((ref[a] + ref[b]) // 2).tolist())
        vert_of[latt] = nv_old + elem_edge[:, le]
    nv_after_edges = nv_old + len(edges)

    # face centers (3D only; 2D "face" = the cell itself handled below)
    if dim == 3:
        faces, elem_face = unique_faces(mesh)
        face_c = mesh.vertices[faces].mean(axis=1)
        new_verts.append(face_c)
        loc_faces = FACES[mesh.geom]
        for lf, fverts in enumerate(loc_faces):
            latt = tuple((sum(ref[v] for v in fverts) // len(fverts)).tolist())
            vert_of[latt] = nv_after_edges + elem_face[:, lf]
        nv_after_faces = nv_after_edges + len(faces)
    else:
        faces = np.zeros((0, 0)); nv_after_faces = nv_after_edges

    # cell centers
    center = mesh.vertices[mesh.elements].mean(axis=1)
    new_verts.append(center)
    vert_of[tuple([1] * dim)] = nv_after_faces + np.arange(mesh.ne)

    vertices = np.concatenate(new_verts, axis=0)

    # children: sub-cells at corner offsets {0,1}^dim; child vertex lattice
    # position = offset + unit-cube corner (both in {0,1}^dim, giving {0,1,2})
    corners = REF_VERTS[mesh.geom].astype(np.int64)   # {0,1}^dim corner offsets
    offsets = corners
    children = []
    for off in offsets:
        child = np.stack(
            [vert_of[tuple((off + corners[v]).tolist())]
             for v in range(NUM_VERTS[mesh.geom])],
            axis=1,
        )
        children.append(child)
    elements = np.concatenate(children, axis=0)
    attributes = np.tile(mesh.attributes, len(offsets))

    # boundary refinement: recurse on the boundary "mesh"
    if mesh.nbe > 0 and dim > 1:
        bgeom = mesh.bdr_geom
        bref = (REF_VERTS[bgeom] * 2).astype(np.int64)
        bvert_of: Dict[Tuple[int, ...], np.ndarray] = {}
        for v_local, latt in enumerate(bref):
            bvert_of[tuple(latt)] = mesh.boundary[:, v_local]
        # boundary edge midpoints — look up in the volume edge table
        edge_lookup = {tuple(e): nv_old + i for i, e in enumerate(map(tuple, edges))}
        bloc_edges = np.array(EDGES[bgeom], dtype=np.int64)
        for le, (a, b) in enumerate(bloc_edges):
            pairs = np.sort(mesh.boundary[:, [a, b]], axis=1)
            ids = np.array([edge_lookup[tuple(pr)] for pr in pairs], dtype=np.int64)
            latt = tuple(((bref[a] + bref[b]) // 2).tolist())
            bvert_of[latt] = ids
        if bgeom == Geometry.SQUARE:
            face_lookup = {
                tuple(f): nv_after_edges + i for i, f in enumerate(map(tuple, faces))
            }
            quads = np.sort(mesh.boundary, axis=1)
            ids = np.array([face_lookup[tuple(qd)] for qd in quads], dtype=np.int64)
            bvert_of[(1, 1)] = ids
        boffsets = (REF_VERTS[bgeom]).astype(np.int64)
        bchildren = []
        for off in boffsets:
            child = np.stack(
                [
                    bvert_of[tuple((off + (REF_VERTS[bgeom][v]).astype(np.int64)).tolist())]
                    for v in range(NUM_VERTS[bgeom])
                ],
                axis=1,
            )
            bchildren.append(child)
        boundary = np.concatenate(bchildren, axis=0)
        bdr_attributes = np.tile(mesh.bdr_attributes, len(boffsets))
    else:
        boundary, bdr_attributes = mesh.boundary, mesh.bdr_attributes

    return Mesh(
        geom=mesh.geom,
        vertices=vertices,
        elements=elements,
        attributes=attributes,
        boundary=boundary,
        bdr_attributes=bdr_attributes,
    )


def _child_corner_coords(geom: Geometry) -> np.ndarray:
    """Parent-reference corner coordinates of each refinement child,
    (nchild, nv_el, dim), in the CHILD BLOCK ORDER the straight refiners
    emit (tensor: per corner offset; triangle: T0..T2 corner-adjacent then
    the inverted center T3)."""
    if geom == Geometry.TRIANGLE:
        return np.array([
            [[0, 0], [0.5, 0], [0, 0.5]],
            [[0.5, 0], [1, 0], [0.5, 0.5]],
            [[0, 0.5], [0.5, 0.5], [0, 1]],
            [[0.5, 0], [0.5, 0.5], [0, 0.5]],
        ])
    corners = REF_VERTS[geom].astype(np.float64)      # {0,1}^dim
    return np.stack([(off + corners) / 2.0 for off in corners])


def _refine_curved(mesh: Mesh) -> Mesh:
    """Uniform refinement of a curved (high-order ``nodes``) mesh.

    The reference refines curved meshes through the nodal GridFunction
    (``mesh/mesh.cpp`` ``UniformRefinement2D/3D`` + ``CurvedMeshUpdate``);
    here each child's geometry E-vector is the parent's order-q map
    composed with the affine child embedding — still degree q, so the
    evaluation ``B_c @ nodes_parent`` reproduces the geometry EXACTLY.
    Child vertices are moved onto the curved geometry (corner lattice
    values), so downstream straight-vertex consumers see consistent
    coordinates.
    """
    from ..fem.basis import h1_nodes, simplex_basis_matrices
    from ..fem.faces import _eval_volume_basis
    from ..fem.fespace import _node_index_lookup, _q1_eval_matrix

    geom, q = mesh.geom, mesh.nodes_order
    if geom not in (Geometry.SEGMENT, Geometry.SQUARE, Geometry.CUBE,
                    Geometry.TRIANGLE):
        raise NotImplementedError(f"curved refinement for {geom}")
    ne = mesh.ne
    straight = Mesh(
        geom=geom, vertices=mesh.vertices, elements=mesh.elements,
        attributes=mesh.attributes, boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes,
    )
    fine = _uniform_refine(straight)

    ref_q = h1_nodes(geom, q).astype(np.float64)      # (nd_q, dim)
    child_corners = _child_corner_coords(geom)        # (nc, nv_el, dim)
    if geom == Geometry.TRIANGLE:
        E, _ = simplex_basis_matrices(geom, 1, ref_q)  # (nd_q, nv_el)
    else:
        E = _q1_eval_matrix(geom, ref_q)
    from ..fem.fespace import _batched_eval

    blocks = []
    for C in child_corners:
        pts = E @ C                                    # child lattice in parent ref
        B_c = _eval_volume_basis(geom, q, pts)         # (nd_q, nd_q)
        blocks.append(_batched_eval(B_c, mesh.nodes))
    nodes = np.concatenate(blocks, axis=0)             # (nc*ne, nd_q, sdim)

    # move the fine vertices onto the curved geometry (corner node values)
    lookup = _node_index_lookup(geom, q)
    latt_v = np.rint(REF_VERTS[geom] * q).astype(np.int64)
    vertices = fine.vertices.copy()
    for lv in range(NUM_VERTS[geom]):
        slot = lookup[tuple(latt_v[lv])]
        vertices[fine.elements[:, lv]] = nodes[:, slot]

    return Mesh(
        geom=geom, vertices=vertices, elements=fine.elements,
        attributes=fine.attributes, boundary=fine.boundary,
        bdr_attributes=fine.bdr_attributes, nodes=nodes, nodes_order=q,
    )


def _refine_tri(mesh: Mesh) -> Mesh:
    """Red refinement of triangles: 4 children via edge midpoints."""
    edges, elem_edge = unique_edges(mesh)
    nv_old = mesh.nv
    mid = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
    vertices = np.concatenate([mesh.vertices, mid], axis=0)
    v0, v1, v2 = (mesh.elements[:, i] for i in range(3))
    # local edges (0,1),(1,2),(2,0)
    m01 = nv_old + elem_edge[:, 0]
    m12 = nv_old + elem_edge[:, 1]
    m20 = nv_old + elem_edge[:, 2]
    children = [
        np.stack([v0, m01, m20], axis=1),
        np.stack([m01, v1, m12], axis=1),
        np.stack([m20, m12, v2], axis=1),
        np.stack([m01, m12, m20], axis=1),
    ]
    elements = np.concatenate(children, axis=0)
    attributes = np.tile(mesh.attributes, 4)
    # boundary segments → 2 children
    edge_lookup = {tuple(e): nv_old + i for i, e in enumerate(map(tuple, edges))}
    b = mesh.boundary
    mids = np.array(
        [edge_lookup[tuple(sorted(pr))] for pr in b], dtype=np.int64
    )
    boundary = np.concatenate(
        [np.stack([b[:, 0], mids], axis=1), np.stack([mids, b[:, 1]], axis=1)], axis=0
    )
    bdr_attributes = np.tile(mesh.bdr_attributes, 2)
    return Mesh(
        geom=mesh.geom,
        vertices=vertices,
        elements=elements,
        attributes=attributes,
        boundary=boundary,
        bdr_attributes=bdr_attributes,
    )
