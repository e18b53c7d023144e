"""AMR forest: dynamic refine + DEREFINE over NC quad/hex meshes.

Reference analog: ``NCMesh`` refinement/derefinement
(``mesh/ncmesh.hpp:241-247``) with ``ThresholdRefiner`` /
``ThresholdDerefiner`` (``mesh/mesh_operators.hpp:175,274``) driving the
ex15-class dynamic-AMR time loop.

Design: the forest is a host-side tree of element nodes (conn,
attr, depth, per-face boundary attributes, parent/children); the ACTIVE
leaves materialize an array ``Mesh`` whose hanging-node constraints are
re-derived geometrically (``mesh/ncmesh.py``), so the device-side solve path
(NCFESpace P/Pᵀ) is unchanged.  Derefinement merges sibling groups whose
leaves are all marked, then un-merges any group whose disappearance would
violate 2:1 balance.  Field transfer both ways is nodal point evaluation
(the ``CoarseFineTransformations`` analog).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fem.geometry import EDGES, FACES, Geometry, REF_VERTS
from .mesh import Mesh
from .ncmesh import (
    NCHexMesh,
    NCQuadMesh,
    _find_constraints,
    _find_constraints_3d,
    _sorted_avg,
    make_nc,
)


@dataclasses.dataclass
class _Node:
    conn: Tuple[int, ...]
    attr: int
    depth: int
    bdr: Dict[int, int]                     # local face -> bdr attribute
    parent: Optional[int] = None
    children: Optional[Tuple[int, ...]] = None


class AMRForest:
    """Dynamic-AMR driver over an initially conforming quad/hex mesh."""

    def __init__(self, mesh: Mesh):
        assert mesh.geom in (Geometry.SQUARE, Geometry.CUBE)
        self.geom = mesh.geom
        self.dim = 2 if mesh.geom == Geometry.SQUARE else 3
        self.verts: List[np.ndarray] = [np.asarray(v) for v in mesh.vertices]
        self.vpos: Dict[tuple, int] = {
            tuple(p): i for i, p in enumerate(mesh.vertices)
        }
        faces = FACES[mesh.geom]
        # root boundary: match mesh.boundary rows to element local faces
        bmap: Dict[tuple, int] = {}
        for row, a in zip(mesh.boundary, mesh.bdr_attributes):
            bmap[tuple(sorted(int(v) for v in row))] = int(a)
        self.nodes: List[_Node] = []
        for e in range(mesh.ne):
            conn = tuple(int(v) for v in mesh.elements[e])
            bdr = {}
            for lf, f in enumerate(faces):
                key = tuple(sorted(conn[v] for v in f))
                if key in bmap:
                    bdr[lf] = bmap[key]
            self.nodes.append(
                _Node(conn=conn, attr=int(mesh.attributes[e]), depth=0,
                      bdr=bdr)
            )
        self.active: List[int] = list(range(mesh.ne))

    # ------------------------------------------------------------------
    def _point_id(self, p: np.ndarray) -> int:
        key = tuple(p)
        if key not in self.vpos:
            self.vpos[key] = len(self.verts)
            self.verts.append(np.asarray(p))
        return self.vpos[key]

    def _make_children(self, nid: int):
        """Create (or reuse) the node's 4/8 children."""
        node = self.nodes[nid]
        if node.children is not None:
            return
        V = lambda i: self.verts[i]
        t = node.conn
        kids = []
        if self.geom == Geometry.SQUARE:
            m01 = self._point_id(0.5 * (V(t[0]) + V(t[1])))
            m12 = self._point_id(0.5 * (V(t[1]) + V(t[2])))
            m23 = self._point_id(0.5 * (V(t[2]) + V(t[3])))
            m30 = self._point_id(0.5 * (V(t[3]) + V(t[0])))
            c = self._point_id(0.25 * (V(t[0]) + V(t[1]) + V(t[2]) + V(t[3])))
            conns = [
                (t[0], m01, c, m30), (m01, t[1], m12, c),
                (c, m12, t[2], m23), (m30, c, m23, t[3]),
            ]
            # parent local edge i -> children {i, (i+1)%4}, same local edge
            child_bdr = [dict() for _ in range(4)]
            for lf, a in node.bdr.items():
                child_bdr[lf][lf] = a
                child_bdr[(lf + 1) % 4][lf] = a
        else:
            verts0 = np.stack([V(v) for v in t])
            latt_v = np.rint(REF_VERTS[Geometry.CUBE] * 2).astype(np.int64)
            lat: Dict[tuple, int] = {}
            for lv in range(8):
                lat[tuple(latt_v[lv])] = t[lv]
            for (la, lb) in EDGES[Geometry.CUBE]:
                m = tuple((latt_v[la] + latt_v[lb]) // 2)
                lat[m] = self._point_id(0.5 * (verts0[la] + verts0[lb]))
            for fverts in FACES[Geometry.CUBE]:
                fc = tuple(latt_v[list(fverts)].sum(axis=0) // 4)
                lat[fc] = self._point_id(_sorted_avg(verts0, list(fverts)))
            lat[(1, 1, 1)] = self._point_id(_sorted_avg(verts0, range(8)))
            conns = []
            for k in (0, 1):
                for j in (0, 1):
                    for i in (0, 1):
                        conns.append((
                            lat[(i, j, k)], lat[(i + 1, j, k)],
                            lat[(i + 1, j + 1, k)], lat[(i, j + 1, k)],
                            lat[(i, j, k + 1)], lat[(i + 1, j, k + 1)],
                            lat[(i + 1, j + 1, k + 1)],
                            lat[(i, j + 1, k + 1)],
                        ))
            # children adjacent to parent face lf inherit it (same local id)
            child_bdr = [dict() for _ in range(8)]
            latt2 = latt_v // 2                  # child (i,j,k) bit coords
            for lf, fverts in enumerate(FACES[Geometry.CUBE]):
                bits = latt2[list(fverts)]
                # the face's fixed axis/value
                ax = [d for d in range(3) if len(set(bits[:, d])) == 1][0]
                val = bits[0, ax]
                for m in range(8):
                    ijk = (m & 1, (m >> 1) & 1, (m >> 2) & 1)
                    if ijk[ax] == val and lf in node.bdr:
                        child_bdr[m][lf] = node.bdr[lf]
        cids = []
        for conn, bd in zip(conns, child_bdr):
            cids.append(len(self.nodes))
            self.nodes.append(_Node(
                conn=tuple(int(x) for x in conn), attr=node.attr,
                depth=node.depth + 1, bdr=bd, parent=nid,
            ))
        node.children = tuple(cids)

    # ------------------------------------------------------------------
    def mesh(self) -> Mesh:
        """Materialize the active-leaf Mesh (vertices compacted: orphaned
        refinement vertices would read as hanging to the geometric
        constraint detector)."""
        conns = np.array([self.nodes[n].conn for n in self.active],
                         dtype=np.int64)
        attrs = np.array([self.nodes[n].attr for n in self.active],
                         dtype=np.int64)
        faces = FACES[self.geom]
        bdr, battr = [], []
        for n in self.active:
            nd = self.nodes[n]
            for lf, a in nd.bdr.items():
                bdr.append([nd.conn[v] for v in faces[lf]])
                battr.append(a)
        bdr = np.array(bdr, dtype=np.int64).reshape(-1, len(faces[0]))
        used = np.unique(conns)
        remap = np.full(len(self.verts), -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        self._last_used = used            # compacted id -> forest id
        return Mesh(
            geom=self.geom,
            vertices=np.array(self.verts)[used],
            elements=remap[conns],
            attributes=attrs,
            boundary=remap[bdr],
            bdr_attributes=np.array(battr, dtype=np.int64),
        )

    def nc(self):
        return make_nc(self.mesh())

    # ------------------------------------------------------------------
    def refine(self, marks: np.ndarray) -> None:
        """Refine marked active leaves (2:1 balance by propagation)."""
        marks = np.asarray(marks, dtype=bool).copy()
        for _ in range(64):
            new_active: List[int] = []
            for al, n in zip(marks, self.active):
                if al:
                    self._make_children(n)
                    new_active.extend(self.nodes[n].children)
                else:
                    new_active.append(n)
            cand = self.active
            self.active = new_active
            m = self.mesh()
            self.active = cand
            extra = self._balance_marks(m, new_active)
            if extra is None or not (extra & ~marks).any():
                self.active = new_active
                return
            marks |= extra

    def _balance_marks(self, m: Mesh, new_active) -> Optional[np.ndarray]:
        """2:1 violation detection on a candidate mesh → marks on the
        CURRENT active list (None = balanced)."""
        cur_index = {n: i for i, n in enumerate(self.active)}

        def to_cur(node_id):
            # candidate leaf (or its parent) back to a current active index
            while node_id not in cur_index:
                node_id = self.nodes[node_id].parent
                if node_id is None:
                    return None
            return cur_index[node_id]

        extra = np.zeros(len(self.active), dtype=bool)
        found = False
        used = self._last_used

        def fwd(edges):
            return {(int(used[a]), int(used[b])) for (a, b) in edges}

        if self.geom == Geometry.SQUARE:
            cons = _find_constraints(m)
            bad_edges = fwd(_bad_master_edges(cons))
            if bad_edges:
                for i, n in enumerate(self.active):
                    t = self.nodes[n].conn
                    for k in range(4):
                        a, b = t[k], t[(k + 1) % 4]
                        if (min(a, b), max(a, b)) in bad_edges:
                            extra[i] = True
                            found = True
        else:
            ec, fc, _hc, bad = _find_constraints_3d(m)
            for (_key, eid, _dirs, _cyc) in bad:
                i = to_cur(new_active[eid])
                if i is not None:
                    extra[i] = True
                    found = True
            bad_edges = fwd(_bad_master_edges(ec))
            if bad_edges:
                for i, n in enumerate(self.active):
                    t = self.nodes[n].conn
                    for (la, lb) in EDGES[Geometry.CUBE]:
                        a, b = t[la], t[lb]
                        if (min(a, b), max(a, b)) in bad_edges:
                            extra[i] = True
                            found = True
        return extra if found else None

    # ------------------------------------------------------------------
    def derefine(self, marks: np.ndarray) -> int:
        """Merge sibling groups whose leaves are ALL marked; skip merges
        that would break 2:1 balance.  Returns the number of merges."""
        marks = np.asarray(marks, dtype=bool)
        cur_index = {n: i for i, n in enumerate(self.active)}
        groups: Dict[int, List[int]] = {}
        for i, n in enumerate(self.active):
            p = self.nodes[n].parent
            if p is not None and marks[i]:
                groups.setdefault(p, []).append(n)
        nchild = 4 if self.geom == Geometry.SQUARE else 8
        # a group is mergeable when ALL nchild siblings are active & marked
        # (stale children records from earlier cycles are harmless)
        merged = {p for p, kids in groups.items() if len(kids) == nchild}
        while True:
            cand_active = self._merged_active(merged)
            save = self.active
            self.active = cand_active
            m = self.mesh()
            self.active = save
            viol = self._deref_violators(m, cand_active, merged)
            if not viol:
                break
            merged -= viol
        if not merged:
            return 0
        self.active = self._merged_active(merged)
        return len(merged)

    def _merged_active(self, merged) -> List[int]:
        out, seen = [], set()
        for n in self.active:
            p = self.nodes[n].parent
            if p is not None and p in merged:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
            else:
                out.append(n)
        return out

    def _deref_violators(self, m: Mesh, cand_active, merged) -> set:
        """Merged parents adjacent to >2:1 jumps in the candidate mesh."""
        viol = set()
        used = self._last_used

        def fwd(edges):
            return {(int(used[a]), int(used[b])) for (a, b) in edges}

        if self.geom == Geometry.SQUARE:
            cons = _find_constraints(m)
            bad_edges = fwd(_bad_master_edges(cons))
            if bad_edges:
                for p in merged:
                    t = self.nodes[p].conn
                    for k in range(4):
                        a, b = t[k], t[(k + 1) % 4]
                        if (min(a, b), max(a, b)) in bad_edges:
                            viol.add(p)
        else:
            ec, fc, _hc, bad = _find_constraints_3d(m)
            owners = {cand_active[eid] for (_k, eid, _d, _c) in bad}
            viol |= owners & merged
            bad_edges = fwd(_bad_master_edges(ec))
            if bad_edges:
                for p in merged:
                    t = self.nodes[p].conn
                    for (la, lb) in EDGES[Geometry.CUBE]:
                        a, b = t[la], t[lb]
                        if (min(a, b), max(a, b)) in bad_edges:
                            viol.add(p)
        return viol


def _bad_master_edges(cons) -> set:
    masters = {(int(r[1]), int(r[2])) for r in cons}
    bad = set()
    for (v, a, b) in cons:
        for sub in ((min(a, v), max(a, v)), (min(v, b), max(v, b))):
            if sub in masters or (sub[1], sub[0]) in masters:
                bad.add((min(a, b), max(a, b)))
    return bad


# ---------------------------------------------------------------------------
# Threshold mesh operators (mesh/mesh_operators.hpp:175,274 analogs)
# ---------------------------------------------------------------------------

def threshold_refine_nc(forest: AMRForest, eta: np.ndarray,
                        frac: float = 0.7,
                        max_elements: Optional[int] = None) -> bool:
    """Mark η > frac·max(η) and refine.  Returns whether anything changed."""
    eta = np.asarray(eta)
    if max_elements is not None and len(forest.active) >= max_elements:
        return False
    marks = eta > frac * eta.max()
    if not marks.any():
        return False
    forest.refine(marks)
    return True


def threshold_derefine_nc(forest: AMRForest, eta: np.ndarray,
                          threshold: float) -> int:
    """ThresholdDerefiner analog: mark leaves whose sibling-group aggregate
    error stays below ``threshold``; merge what balance allows."""
    eta = np.asarray(eta)
    cur_index = {n: i for i, n in enumerate(forest.active)}
    groups: Dict[int, List[int]] = {}
    for i, n in enumerate(forest.active):
        p = forest.nodes[n].parent
        if p is not None:
            groups.setdefault(p, []).append(i)
    nchild = 4 if forest.geom == Geometry.SQUARE else 8
    marks = np.zeros(len(forest.active), dtype=bool)
    for p, idxs in groups.items():
        if len(idxs) == nchild:
            total = float(np.sqrt(np.sum(eta[idxs] ** 2)))
            if total < threshold:
                marks[idxs] = True
    if not marks.any():
        return 0
    return forest.derefine(marks)
