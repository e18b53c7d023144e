"""Adaptive mesh refinement: conforming newest-vertex bisection (triangles).

Reference analog: the AMR loop of ``examples/ex6.cpp`` — estimator →
``ThresholdRefiner::Apply`` → ``Mesh::GeneralRefinement`` →
``FESpace::Update`` (SURVEY.md §3.5).  The reference's general machinery is
the 11k-LoC NCMesh (hanging nodes); per SURVEY.md §7 hard-parts item 4 this
package re-scopes round 1 to **conforming** adaptivity: newest-vertex
bisection on triangle meshes (always conforming, shape-regular, terminating),
with nonconforming 2:1 quad/hex AMR tracked for a later round.

Solution transfer: since bisection only adds vertices, the old solution is
interpolated onto the new mesh by nodal evaluation (`interp_after_refine`) —
the CoarseFineTransformations analog for nodal H1 spaces.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fem.geometry import Geometry
from .mesh import Mesh


def _longest_edge_first(tri: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Rotate each triangle so its longest edge is (v0, v1) — the initial
    refinement-edge labeling for NVB."""
    out = tri.copy()
    for i, t in enumerate(tri):
        p = verts[t]
        L = [
            np.linalg.norm(p[1] - p[0]),  # edge (0,1)
            np.linalg.norm(p[2] - p[1]),  # edge (1,2)
            np.linalg.norm(p[0] - p[2]),  # edge (2,0)
        ]
        k = int(np.argmax(L))
        out[i] = np.roll(t, -k)
    return out


def bisect_marked(mesh: Mesh, marks: np.ndarray,
                  _relabel: bool = True) -> Tuple[Mesh, np.ndarray]:
    """Bisect marked triangles (+ compatibility closure) → (new mesh,
    parent_of (ne_new,) old-element index of each new element).

    The refinement edge of every triangle is its (v0, v1) edge; meshes not
    produced by this function are relabeled longest-edge-first.
    """
    if mesh.geom != Geometry.TRIANGLE:
        raise NotImplementedError("bisection AMR: triangle meshes only")
    tris = (
        _longest_edge_first(mesh.elements, mesh.vertices)
        if _relabel
        else mesh.elements.copy()
    )
    tris = [list(t) for t in tris]
    attrs = list(mesh.attributes)
    parent = list(range(len(tris)))
    verts: List[np.ndarray] = [v for v in mesh.vertices]
    midpoint: Dict[Tuple[int, int], int] = {}
    alive = [True] * len(tris)

    def edge_key(a, b):
        return (a, b) if a < b else (b, a)

    # map refinement edge -> element (for compatibility lookups)
    def build_edge_map():
        em: Dict[Tuple[int, int], List[int]] = {}
        for i, t in enumerate(tris):
            if not alive[i]:
                continue
            em.setdefault(edge_key(t[0], t[1]), []).append(i)
        return em

    def get_mid(a, b):
        k = edge_key(a, b)
        if k not in midpoint:
            verts.append(0.5 * (verts[a] + verts[b]))
            midpoint[k] = len(verts) - 1
        return midpoint[k]

    def bisect(i):
        """Bisect element i across its refinement edge (t0, t1)."""
        t = tris[i]
        m = get_mid(t[0], t[1])
        alive[i] = False
        # children with refinement edges (v2, v0) and (v1, v2)
        tris.append([t[2], t[0], m]); attrs.append(attrs[i]); parent.append(parent[i]); alive.append(True)
        tris.append([t[1], t[2], m]); attrs.append(attrs[i]); parent.append(parent[i]); alive.append(True)

    def refine_conforming(i, depth=0):
        if depth > 64:
            raise RuntimeError("bisection recursion runaway")
        t = tris[i]
        k = edge_key(t[0], t[1])
        # find the neighbor across the refinement edge (if any)
        nbr = None
        for j, tj in enumerate(tris):
            if j == i or not alive[j]:
                continue
            if t[0] in tj and t[1] in tj:
                nbr = j
                break
        if nbr is not None:
            kn = edge_key(tris[nbr][0], tris[nbr][1])
            if kn != k:
                refine_conforming(nbr, depth + 1)
                # neighbor was replaced; the edge may now be shared with one
                # of its children whose refinement edge IS our edge
                return refine_conforming(i, depth + 1)
        bisect(i)
        if nbr is not None:
            bisect(nbr)

    for i in np.nonzero(np.asarray(marks))[0]:
        if alive[i]:
            refine_conforming(int(i))

    # fix dangling midpoints: any alive triangle with a split edge must be
    # bisected until conforming
    changed = True
    while changed:
        changed = False
        for i in range(len(tris)):
            if not alive[i]:
                continue
            t = tris[i]
            for (a, b) in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                if edge_key(a, b) in midpoint:
                    refine_conforming(i)
                    changed = True
                    break

    keep = [i for i in range(len(tris)) if alive[i]]
    new_tris = np.array([tris[i] for i in keep], dtype=np.int64)
    new_attrs = np.array([attrs[i] for i in keep], dtype=np.int64)
    parent_of = np.array([parent[i] for i in keep], dtype=np.int64)

    # boundary: split segments whose midpoint exists
    bdr, battr = [], []
    for seg, a in zip(mesh.boundary, mesh.bdr_attributes):
        k = edge_key(int(seg[0]), int(seg[1]))
        if k in midpoint:
            m = midpoint[k]
            # recursively split (midpoints of sub-segments may exist too)
            stack = [(int(seg[0]), m), (m, int(seg[1]))]
            out = []
            while stack:
                s = stack.pop()
                kk = edge_key(*s)
                if kk in midpoint:
                    mm = midpoint[kk]
                    stack += [(s[0], mm), (mm, s[1])]
                else:
                    out.append(s)
            for s in out:
                bdr.append(s); battr.append(a)
        else:
            bdr.append((int(seg[0]), int(seg[1]))); battr.append(a)

    new_mesh = Mesh(
        geom=Geometry.TRIANGLE,
        vertices=np.array(verts),
        elements=new_tris,
        attributes=new_attrs,
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )
    return new_mesh, parent_of


def threshold_refine(mesh: Mesh, eta: np.ndarray, frac: float = 0.7,
                     max_elements: Optional[int] = None):
    """ThresholdRefiner::Apply analog (mesh/mesh_operators.hpp:175): mark
    elements with eta > frac·max(eta) and bisect.  Returns (mesh, parent_of,
    marked_any)."""
    eta = np.asarray(eta)
    thr = frac * eta.max()
    marks = eta > thr
    if max_elements is not None and mesh.ne >= max_elements:
        return mesh, np.arange(mesh.ne), False
    if not marks.any():
        return mesh, np.arange(mesh.ne), False
    new_mesh, parent = bisect_marked(mesh, marks)
    return new_mesh, parent, True


def interp_after_refine(old_fes, new_fes, u_old) -> np.ndarray:
    """Transfer an H1 solution to the refined mesh by nodal point evaluation
    (CoarseFineTransformations analog).  Host-side; setup path."""
    import jax.numpy as jnp

    from .point_eval import evaluate_at_points

    vals = evaluate_at_points(old_fes, np.asarray(u_old), new_fes.dof_coords)
    return jnp.asarray(vals)


# ---------------------------------------------------------------------------
# 3D: conforming longest-edge bisection for tetrahedra
# ---------------------------------------------------------------------------

_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def bisect_marked_tets(mesh: Mesh, marks: np.ndarray,
                       max_rounds: int = 200) -> Tuple[Mesh, np.ndarray]:
    """Bisect marked tets (longest-edge / Rivara) with conforming closure.

    Reference analog: ``Mesh::GeneralRefinement`` on tet meshes — the
    reference uses NCMesh hanging nodes; here (as for triangles, SURVEY §7
    hard-part 4) adaptivity is *conforming*: every tet is bisected across
    its longest edge (ties broken by the sorted global-id pair, so the two
    tets sharing a face always agree), and any tet with a midpoint hanging
    on one of its edges is bisected until no hanging midpoints remain —
    the Rivara longest-edge propagation, which terminates.

    Returns (new mesh, parent_of) with boundary triangles split
    consistently and attributes inherited.
    """
    if mesh.geom != Geometry.TETRAHEDRON:
        raise NotImplementedError("bisect_marked_tets: tet meshes")
    tets = [list(map(int, t)) for t in mesh.elements]
    attrs = list(mesh.attributes)
    parent = list(range(len(tets)))
    alive = [True] * len(tets)
    verts: List[np.ndarray] = [v for v in mesh.vertices]
    midpoint: Dict[Tuple[int, int], int] = {}

    def ekey(a, b):
        return (a, b) if a < b else (b, a)

    def get_mid(a, b):
        k = ekey(a, b)
        if k not in midpoint:
            verts.append(0.5 * (verts[a] + verts[b]))
            midpoint[k] = len(verts) - 1
        return midpoint[k]

    def longest_edge(t):
        """Longest edge of tet t; ties broken by the sorted id pair (both
        tets sharing a face pick the same edge of that face)."""
        best = None
        for (i, j) in _TET_EDGES:
            a, b = t[i], t[j]
            L = float(np.dot(verts[a] - verts[b], verts[a] - verts[b]))
            cand = (-L, ekey(a, b))
            if best is None or cand < best:
                best = cand
        return best[1]

    def bisect(i):
        t = tets[i]
        a, b = longest_edge(t)
        m = get_mid(a, b)
        ia, ib = t.index(a), t.index(b)
        c1 = list(t)
        c1[ib] = m
        c2 = list(t)
        c2[ia] = m
        alive[i] = False
        for ch in (c1, c2):
            tets.append(ch)
            attrs.append(attrs[i])
            parent.append(parent[i])
            alive.append(True)

    for i in np.nonzero(np.asarray(marks, dtype=bool))[0]:
        if alive[int(i)]:
            bisect(int(i))

    # conforming closure: bisect any tet with a hanging edge midpoint
    for _ in range(max_rounds):
        dirty = []
        for i in range(len(tets)):
            if not alive[i]:
                continue
            t = tets[i]
            if any(ekey(t[p], t[q]) in midpoint for (p, q) in _TET_EDGES):
                dirty.append(i)
        if not dirty:
            break
        for i in dirty:
            if alive[i]:
                bisect(i)
    else:
        raise RuntimeError("tet bisection closure did not terminate")

    keep = [i for i in range(len(tets)) if alive[i]]
    new_tets = np.array([tets[i] for i in keep], dtype=np.int64)
    new_attrs = np.array([attrs[i] for i in keep], dtype=np.int64)
    parent_of = np.array([parent[i] for i in keep], dtype=np.int64)

    # boundary: split boundary triangles across their midpointed edges
    bdr, battr = [], []
    for tri, a in zip(mesh.boundary, mesh.bdr_attributes):
        stack = [tuple(int(v) for v in tri)]
        while stack:
            f = stack.pop()
            split = None
            # split across the LONGEST midpointed edge (matches the tet
            # bisection order, which always splits longest-first)
            best = None
            for k in range(3):
                p, q = f[k], f[(k + 1) % 3]
                if ekey(p, q) in midpoint:
                    L = float(np.dot(verts[p] - verts[q],
                                     verts[p] - verts[q]))
                    cand = (-L, ekey(p, q), k)
                    if best is None or cand < best:
                        best = cand
            if best is not None:
                k = best[2]
                p, q = f[k], f[(k + 1) % 3]
                r = f[(k + 2) % 3]
                m = midpoint[ekey(p, q)]
                stack += [(p, m, r), (m, q, r)]
            else:
                bdr.append(list(f))
                battr.append(a)

    new_mesh = Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=np.array(verts),
        elements=new_tets,
        attributes=new_attrs,
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )
    return new_mesh, parent_of
