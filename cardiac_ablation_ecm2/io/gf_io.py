"""MFEM GridFunction (.gf) save/load at arbitrary H1 order.

Reference analogs: ``GridFunction::Save`` (fem/gridfunc.cpp:4142) and the
stream constructor / ``Load`` (fem/gridfunc.cpp:40) — the format is a
FiniteElementSpace header followed by one dof value per line, in MFEM's
GLOBAL dof ordering.

Replicating that ordering exactly is the whole task (fem/fespace.cpp
``GetElementDofs``, :3426):

* block layout  [vertex dofs | edge dofs | face dofs | element interiors];
* edges are numbered in DISCOVERY order — scanning elements in order, local
  edges in the geometry's local-edge order (mesh/mesh.cpp
  ``GetElementToEdgeTable``); global edge dofs run from the LOWER global
  vertex index to the higher (``Mesh::GetElementEdges`` sets
  ``cor = v[e0] < v[e1]``, mesh.cpp:7867; ``SegDofOrd`` fe_coll.cpp:1788);
* faces likewise in discovery order (``GetElementToFaceTable``), each face
  storing the vertex CYCLE of its first-discovering element
  (``AddTriangleFaceElement`` / ``AddQuadFaceElement``, mesh.cpp:8491);
  face dofs are stored in the face element's native interior ordering with
  respect to that cycle, and elements extract them through the
  ``TriDofOrd``/``QuadDofOrd`` orientation maps (fe_coll.cpp:1826-1906)
  keyed by ``GetTriOrientation``/``GetQuadOrientation`` (mesh.cpp:7291,7380);
* node placement follows fe_h1.cpp: Gauss-Lobatto closed points on tensor
  elements, GLL-warped barycentric points on simplices (interior node of a
  triangle at (cp_i/w, cp_j/w), w = cp_i + cp_j + cp_{p-i-j},
  fe_h1.cpp:504-511; tets fe_h1.cpp:726-734).

Design: everything is reference-space and host-side.  One
(ndl × ndl) transfer matrix per geometry/order — OUR nodal basis evaluated
at MFEM's local node set — converts between the two dof conventions:
``W u_ours`` gives the values at MFEM's nodes (write), ``W⁻¹ w`` gives ours
(read).  Works at ANY order on straight or curved meshes (the map never
touches physical coordinates), including the simplex p ≥ 4 case where the
two node sets genuinely differ (same polynomial space ⇒ the transfer is
exact interpolation, not approximation).
"""

from __future__ import annotations

import functools
import io as _io
import re
from typing import Optional

import numpy as np

from ..fem.basis import (h1_nodes, h1_nodes_1d, lagrange_matrices,
                         lattice_multi_index, simplex_basis_matrices)
from ..fem.geometry import DIMENSION, FACES, IS_TENSOR, REF_VERTS, Geometry

# Local edge tables in MFEM's order (fem/geom.cpp Constants<*>::Edges —
# these differ from our fem.geometry.EDGES for tets/hexes, where ours are
# cycle-ordered; format compatibility requires MFEM's exact lists).
MFEM_EDGES = {
    Geometry.SEGMENT: [(0, 1)],
    Geometry.TRIANGLE: [(0, 1), (1, 2), (2, 0)],
    Geometry.SQUARE: [(0, 1), (1, 2), (2, 3), (3, 0)],
    Geometry.TETRAHEDRON: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
    Geometry.CUBE: [(0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6),
                    (4, 7), (0, 4), (1, 5), (2, 6), (3, 7)],
}
# Local faces (fem/geom.cpp FaceVert) — identical to our FACES tables.
MFEM_FACES = FACES


def _tri_orientation(base, test) -> int:
    """Mesh::GetTriOrientation (mesh/mesh.cpp:7291)."""
    if test[0] == base[0]:
        return 0 if test[1] == base[1] else 5
    if test[0] == base[1]:
        return 1 if test[1] == base[0] else 2
    return 4 if test[1] == base[0] else 3


def _quad_orientation(base, test) -> int:
    """Mesh::GetQuadOrientation (mesh/mesh.cpp:7380)."""
    i = next(k for k in range(4) if test[k] == base[0])
    return 2 * i if test[(i + 1) % 4] == base[1] else 2 * i + 1


@functools.lru_cache(maxsize=None)
def _seg_dof_ord(p: int, orient: int) -> np.ndarray:
    """SegDofOrd (fe_coll.cpp:1788-1793)."""
    n = p - 1
    return np.arange(n) if orient > 0 else (n - 1) - np.arange(n)


@functools.lru_cache(maxsize=None)
def _tri_dof_ord(p: int, orient: int) -> np.ndarray:
    """TriDofOrd (fe_coll.cpp:1826-1843): interior-dof permutation of a
    triangle face under orientation ``orient``."""
    pm1, pm2, pm3 = p - 1, p - 2, p - 3
    ndof = (pm1 * pm2) // 2
    out = np.zeros(ndof, dtype=np.int64)
    for j in range(pm2):
        for i in range(pm2 - j):
            o = ndof - ((pm1 - j) * (pm2 - j)) // 2 + i
            k = pm3 - j - i
            out[o] = [
                o,
                ndof - ((pm1 - j) * (pm2 - j)) // 2 + k,
                ndof - ((pm1 - i) * (pm2 - i)) // 2 + k,
                ndof - ((pm1 - k) * (pm2 - k)) // 2 + i,
                ndof - ((pm1 - k) * (pm2 - k)) // 2 + j,
                ndof - ((pm1 - i) * (pm2 - i)) // 2 + j,
            ][orient]
    return out


@functools.lru_cache(maxsize=None)
def _quad_dof_ord(p: int, orient: int) -> np.ndarray:
    """QuadDofOrd, tensor-product case (fe_coll.cpp:1890-1906)."""
    pm1, pm2 = p - 1, p - 2
    out = np.zeros(pm1 * pm1, dtype=np.int64)
    for j in range(pm1):
        for i in range(pm1):
            o = i + j * pm1
            out[o] = [
                i + j * pm1, j + i * pm1,
                j + (pm2 - i) * pm1, (pm2 - i) + j * pm1,
                (pm2 - i) + (pm2 - j) * pm1, (pm2 - j) + (pm2 - i) * pm1,
                (pm2 - j) + i * pm1, i + (pm2 - j) * pm1,
            ][orient]
    return out


def _edge_table(mesh):
    """(edge index dict {(a,b)->id}, per-element edge ids (ne, nle),
    per-element ±1 orientations) in MFEM's discovery order
    (mesh/mesh.cpp GetElementToEdgeTable)."""
    loc = MFEM_EDGES[mesh.geom]
    elems = mesh.elements
    ne = elems.shape[0]
    edges: dict = {}
    eids = np.zeros((ne, len(loc)), dtype=np.int64)
    eori = np.zeros((ne, len(loc)), dtype=np.int64)
    for e in range(ne):
        v = elems[e]
        for li, (a, b) in enumerate(loc):
            ga, gb = int(v[a]), int(v[b])
            key = (ga, gb) if ga < gb else (gb, ga)
            idx = edges.get(key)
            if idx is None:
                idx = len(edges)
                edges[key] = idx
            eids[e, li] = idx
            eori[e, li] = 1 if ga < gb else -1
    return edges, eids, eori


def _face_table(mesh):
    """(stored cycles list, per-element face ids, per-element orientation
    ints) in MFEM's discovery order (GetElementToFaceTable +
    GenerateFaces/AddXFaceElement)."""
    loc = MFEM_FACES[mesh.geom]
    elems = mesh.elements
    ne = elems.shape[0]
    faces: dict = {}
    cycles: list = []
    fids = np.zeros((ne, len(loc)), dtype=np.int64)
    fori = np.zeros((ne, len(loc)), dtype=np.int64)
    for e in range(ne):
        v = elems[e]
        for li, cyc in enumerate(loc):
            gcyc = tuple(int(v[c]) for c in cyc)
            key = tuple(sorted(gcyc))
            idx = faces.get(key)
            if idx is None:
                idx = len(faces)
                faces[key] = idx
                cycles.append(gcyc)
                ori = 0
            else:
                base = cycles[idx]
                ori = (_tri_orientation(base, gcyc) if len(cyc) == 3
                       else _quad_orientation(base, gcyc))
            fids[e, li] = idx
            fori[e, li] = ori
    return cycles, fids, fori


# ---------------------------------------------------------------------------
# MFEM local node sets (native hierarchical ordering)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mfem_local_nodes(geom: Geometry, p: int) -> np.ndarray:
    """Reference coordinates of the H1 element's nodes in MFEM's native
    ordering: vertices, per-edge, per-face, interior (fe_h1.cpp ctors /
    TensorBasisElement H1_DOF_MAP, fe_base.cpp:2440-2601)."""
    cp = h1_nodes_1d(p)
    rv = REF_VERTS[geom]
    dim = DIMENSION[geom]
    pts = [rv[i] for i in range(rv.shape[0])]
    for (a, b) in MFEM_EDGES[geom]:
        for i in range(1, p):
            pts.append(rv[a] + cp[i] * (rv[b] - rv[a]))
    if dim == 3:
        for cyc in MFEM_FACES[geom]:
            if len(cyc) == 3:
                A, B, C = rv[cyc[0]], rv[cyc[1]], rv[cyc[2]]
                for j in range(1, p):
                    for i in range(1, p - j):
                        w = cp[i] + cp[j] + cp[p - i - j]
                        pts.append((cp[p - i - j] * A + cp[i] * B
                                    + cp[j] * C) / w)
            else:
                A, B, C, D = (rv[c] for c in cyc)
                for j in range(1, p):
                    for i in range(1, p):
                        u, v = cp[i], cp[j]
                        pts.append((1 - u) * (1 - v) * A + u * (1 - v) * B
                                   + u * v * C + (1 - u) * v * D)
    # interior
    if geom == Geometry.SEGMENT:
        pass  # edge loop above already added them (the element IS its edge)
    elif geom == Geometry.SQUARE:
        for j in range(1, p):
            for i in range(1, p):
                pts.append(np.array([cp[i], cp[j]]))
    elif geom == Geometry.CUBE:
        for k in range(1, p):
            for j in range(1, p):
                for i in range(1, p):
                    pts.append(np.array([cp[i], cp[j], cp[k]]))
    elif geom == Geometry.TRIANGLE:
        for j in range(1, p):
            for i in range(1, p - j):
                w = cp[i] + cp[j] + cp[p - i - j]
                pts.append(np.array([cp[i] / w, cp[j] / w]))
    elif geom == Geometry.TETRAHEDRON:
        for k in range(1, p):
            for j in range(1, p - k):
                for i in range(1, p - j - k):
                    w = cp[i] + cp[j] + cp[k] + cp[p - i - j - k]
                    pts.append(np.array([cp[i] / w, cp[j] / w, cp[k] / w]))
    else:
        raise NotImplementedError(f".gf interop: geometry {geom}")
    return np.asarray(pts, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _entity_dof_counts(geom: Geometry, p: int):
    """(n_per_edge, n_per_face(list per local face), n_interior)."""
    ne1 = p - 1
    dim = DIMENSION[geom]
    nf = []
    if dim == 3:
        for cyc in MFEM_FACES[geom]:
            nf.append(((p - 1) * (p - 2)) // 2 if len(cyc) == 3
                      else (p - 1) * (p - 1))
    if geom == Geometry.SEGMENT:
        nb = p - 1
        ne1 = 0
    elif geom == Geometry.SQUARE:
        nb = (p - 1) ** 2
    elif geom == Geometry.CUBE:
        nb = (p - 1) ** 3
    elif geom == Geometry.TRIANGLE:
        nb = ((p - 1) * (p - 2)) // 2
    elif geom == Geometry.TETRAHEDRON:
        nb = ((p - 1) * (p - 2) * (p - 3)) // 6
    else:
        raise NotImplementedError(geom)
    return ne1, nf, nb


def mfem_element_dofs(mesh, p: int):
    """Per-element MFEM global dof ids in native local order (ne, ndl),
    plus the total MFEM dof count — FiniteElementSpace::GetElementDofs
    (fespace.cpp:3426) replicated for fixed-order H1."""
    geom = mesh.geom
    dim = DIMENSION[geom]
    elems = mesh.elements
    ne = elems.shape[0]
    ne1, nf_per, nb = _entity_dof_counts(geom, p)

    nvdofs = mesh.nv
    blocks = [elems.astype(np.int64)]                      # vertex dofs

    nedofs = 0
    if dim >= 2 and ne1 > 0:
        _, eids, eori = _edge_table(mesh)
        nedges = int(eids.max()) + 1 if eids.size else 0
        nedofs = nedges * ne1
        ed = np.zeros((ne, eids.shape[1] * ne1), dtype=np.int64)
        for li in range(eids.shape[1]):
            for o in (1, -1):
                sel = eori[:, li] == o
                ind = _seg_dof_ord(p, o)
                ed[sel, li * ne1:(li + 1) * ne1] = (
                    nvdofs + eids[sel, li][:, None] * ne1 + ind[None, :])
        blocks.append(ed)

    nfdofs = 0
    if dim == 3 and sum(nf_per) > 0:
        cycles, fids, fori = _face_table(mesh)
        # fixed-order: every face has the same geometry here (single-geometry
        # meshes), so fbase = fid * nf
        nfaces = len(cycles)
        nf = nf_per[0]
        nfdofs = nfaces * nf
        if nf > 0:
            fd = np.zeros((ne, fids.shape[1] * nf), dtype=np.int64)
            tri = len(MFEM_FACES[geom][0]) == 3
            for li in range(fids.shape[1]):
                for o in range(6 if tri else 8):
                    sel = fori[:, li] == o
                    if not sel.any():
                        continue
                    ind = (_tri_dof_ord(p, o) if tri else _quad_dof_ord(p, o))
                    fd[sel, li * nf:(li + 1) * nf] = (
                        nvdofs + nedofs + fids[sel, li][:, None] * nf
                        + ind[None, :])
            blocks.append(fd)

    if nb > 0:
        base = nvdofs + nedofs + nfdofs
        bd = base + np.arange(ne, dtype=np.int64)[:, None] * nb \
            + np.arange(nb, dtype=np.int64)[None, :]
        blocks.append(bd)

    eldofs = np.concatenate(blocks, axis=1)
    ndof = nvdofs + nedofs + nfdofs + ne * nb
    return eldofs, ndof


@functools.lru_cache(maxsize=None)
def _transfer_matrix(geom: Geometry, p: int) -> np.ndarray:
    """W[m, l] = φ_l^{ours}(X_m): our local H1 basis (lattice lex order, as
    in ``fes.gather_map``) evaluated at MFEM's native local nodes.
    ``W @ u_local`` = values at MFEM nodes; ``W⁻¹ @ w`` = our dof values."""
    X = _mfem_local_nodes(geom, p)
    if IS_TENSOR.get(geom, False) or geom == Geometry.SEGMENT:
        mi = lattice_multi_index(geom, p)
        nodes = h1_nodes_1d(p)
        dim = DIMENSION[geom]
        B1 = [lagrange_matrices(nodes, X[:, d])[0] for d in range(dim)]
        W = np.ones((X.shape[0], mi.shape[0]))
        for d in range(dim):
            W = W * B1[d][:, mi[:, d]]
        return W
    B, _ = simplex_basis_matrices(geom, p, X)
    return np.asarray(B)


@functools.lru_cache(maxsize=None)
def _transfer_matrix_inv(geom: Geometry, p: int) -> np.ndarray:
    return np.linalg.inv(_transfer_matrix(geom, p))


# ---------------------------------------------------------------------------
# Save / Load
# ---------------------------------------------------------------------------

def gridfunction_values(fes, u) -> np.ndarray:
    """Dof values of ``u`` in MFEM's global ordering (per component)."""
    mesh = fes.mesh
    p = fes.order
    eldofs, ndof = mfem_element_dofs(mesh, p)
    W = _transfer_matrix(mesh.geom, p)
    u = np.asarray(u)
    vdim = getattr(fes, "vdim", 1)
    ns = fes.ndof_scalar
    comps = u.reshape(vdim, ns)
    out = np.zeros((vdim, ndof), dtype=np.float64)
    gm = np.asarray(fes.gather_map)
    for c in range(vdim):
        ue = comps[c][gm]                      # (ne, ndl) our local values
        vals = ue @ W.T                        # values at MFEM local nodes
        out[c][eldofs.reshape(-1)] = vals.reshape(-1)
    return out


def write_gridfunction(path, fes, u, ordering: int = 0) -> None:
    """GridFunction::Save format (fem/gridfunc.cpp:4142): header + one dof
    value per line in MFEM's global dof ordering."""
    vals = gridfunction_values(fes, u)
    vdim, _ = vals.shape
    flat = vals.reshape(-1) if ordering == 0 else vals.T.reshape(-1)
    close = isinstance(path, str)
    f = open(path, "w") if close else path
    try:
        f.write("FiniteElementSpace\n")
        f.write(f"FiniteElementCollection: H1_{fes.mesh.dim}D_P{fes.order}\n")
        f.write(f"VDim: {vdim}\nOrdering: {ordering}\n\n")
        for v in flat:
            f.write(f"{float(v)!r}\n")
    finally:
        if close:
            f.close()


_HDR = re.compile(r"FiniteElementCollection:\s*(\S+)")


def read_gridfunction(path, fes) -> np.ndarray:
    """Load a .gf written by MFEM (or by us) onto ``fes``; returns the
    (vdim·ndof_scalar,) byNODES dof vector.  The mesh/space must match the
    one the file was written on (same elements in the same order)."""
    close = isinstance(path, str)
    f = open(path) if close else path
    try:
        text = f.read()
    finally:
        if close:
            f.close()
    lines = text.splitlines()
    assert lines[0].strip() == "FiniteElementSpace", lines[0]
    m = _HDR.match(lines[1].strip())
    name = m.group(1)
    em = re.match(r"H1_(\d)D_P(\d+)", name)
    if not em or int(em.group(2)) != fes.order:
        raise ValueError(f"collection {name!r} does not match H1 order "
                         f"{fes.order}")
    vdim = 1
    ordering = 0
    k = 2
    while k < len(lines) and lines[k].strip():
        key, _, val = lines[k].partition(":")
        if key.strip() == "VDim":
            vdim = int(val)
        elif key.strip() == "Ordering":
            ordering = int(val)
        k += 1
    vals = np.array([float(x) for x in lines[k:] if x.strip()])

    mesh = fes.mesh
    p = fes.order
    eldofs, ndof = mfem_element_dofs(mesh, p)
    if vals.size != vdim * ndof:
        raise ValueError(f"{vals.size} values != vdim {vdim} × ndof {ndof}")
    comps = (vals.reshape(vdim, ndof) if ordering == 0
             else vals.reshape(ndof, vdim).T)
    Winv = _transfer_matrix_inv(mesh.geom, p)
    gm = np.asarray(fes.gather_map)
    ns = fes.ndof_scalar
    out = np.zeros((vdim, ns))
    for c in range(vdim):
        we = comps[c][eldofs]                  # (ne, ndl) MFEM local values
        ue = we @ Winv.T                       # our local dof values
        out[c][gm.reshape(-1)] = ue.reshape(-1)
    return out.reshape(-1) if vdim > 1 else out[0]
