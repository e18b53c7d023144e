"""Variable-order (p-adaptive) H1 spaces on quad meshes.

Reference analog: variable-order ``FiniteElementSpace`` + ``pRefinement``
(``fem/fespace.hpp:63``; edge dofs take the MINIMUM order of the adjacent
elements, and higher-order element traces are constrained to interpolate
the lower-order edge polynomial — the conforming p-adaptive rule).

Design: elements are grouped by order; each group applies its
own sum-factorized PA kernel on (ne_g, nd_g) E-vectors.  Conformity is a
per-element linear map ``u_E = T_e · u_slots`` where slots gather the
element's global entity dofs: T is identity on own-order entities and a 1D
GLL interpolation block on demoted edges.  T is batched per group (dense
(nd, nslot) matmuls), and the transpose scatter reuses the
deterministic segment-sum restriction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..mesh.mesh import Mesh, unique_edges
from ..utils.config import index_t
from .basis import h1_nodes_1d, lagrange_matrices, lattice_multi_index
from .geometry import EDGES, Geometry


@dataclasses.dataclass(eq=False)
class VarOrderFESpace:
    """p-adaptive H1 space on a quad mesh with per-element orders."""

    mesh: Mesh
    orders: np.ndarray                  # (ne,) int

    def __post_init__(self):
        mesh = self.mesh
        orders = np.asarray(self.orders, dtype=np.int64)
        assert len(orders) == mesh.ne
        self.orders = orders
        if mesh.geom == Geometry.CUBE:
            self._build_3d()
            return
        assert mesh.geom == Geometry.SQUARE, \
            "varorder: quad/hex meshes"

        edges, elem_edge = unique_edges(mesh)
        nedge = len(edges)
        # edge order = min of adjacent element orders
        edge_order = np.full(nedge, 10 ** 9, dtype=np.int64)
        loc_edges = np.array(EDGES[mesh.geom])
        for e in range(mesh.ne):
            for le in range(4):
                eid = elem_edge[e, le]
                edge_order[eid] = min(edge_order[eid], orders[e])

        # global dof numbering: vertices, edge interiors, cell interiors
        nv = mesh.nv
        edge_base = np.zeros(nedge + 1, dtype=np.int64)
        np.cumsum(np.maximum(edge_order - 1, 0), out=edge_base[1:])
        edge_base = nv + edge_base
        cell_base = np.zeros(mesh.ne + 1, dtype=np.int64)
        np.cumsum((orders - 1) ** 2, out=cell_base[1:])
        cell_base = edge_base[-1] + cell_base
        self.ndof = int(cell_base[-1])
        self.edge_order = edge_order

        # per element: slot list (global dofs feeding its T map) and T
        groups: Dict[int, List[int]] = {}
        for e in range(mesh.ne):
            groups.setdefault(int(orders[e]), []).append(e)
        self.groups = {}
        V = mesh.vertices

        for p, els in groups.items():
            mi = lattice_multi_index(Geometry.SQUARE, p)
            nd = len(mi)
            latt_index = {tuple(q): i for i, q in enumerate(mi)}
            # max slots: 4 vertices + 4 edges (own order) + interior
            slot_rows, T_rows = [], []
            max_ns = 4 + sum(1 for _ in range(4)) * (p - 1) + (p - 1) ** 2
            for e in els:
                conn = [int(v) for v in mesh.elements[e]]
                slots: List[int] = []
                T = np.zeros((nd, max_ns))

                def add_slot(g):
                    slots.append(g)
                    return len(slots) - 1

                # vertices: lattice corners
                corner_latt = [(0, 0), (p, 0), (p, p), (0, p)]
                for lv, latt in enumerate(corner_latt):
                    s = add_slot(conn[lv])
                    T[latt_index[latt], s] = 1.0
                # edges
                gll_p = h1_nodes_1d(p)
                for le, (a, b) in enumerate(EDGES[Geometry.SQUARE]):
                    eid = elem_edge[e, le]
                    q = int(edge_order[eid])
                    ga, gb = conn[a], conn[b]
                    fwd = ga < gb          # global edge dir: min→max id
                    # lattice points of this local edge, in local a→b order
                    la = np.array(corner_latt[a])
                    lb = np.array(corner_latt[b])
                    pts = [tuple(la + (lb - la) * t // p)
                           for t in range(1, p)]
                    # local parameters along global direction
                    tloc = gll_p[1:p]
                    tglob = tloc if fwd else 1.0 - tloc
                    if q == p:
                        # own order: direct edge dofs (stored min→max)
                        for k in range(p - 1):
                            g = int(edge_base[eid] + k)
                            s = add_slot(g)
                            # dof k sits at global param gll_p[k+1]
                            # local lattice point with tglob == gll_p[k+1]
                            idx = k if fwd else (p - 2 - k)
                            T[latt_index[pts[idx]], s] = 1.0
                    else:
                        # demoted edge: interpolate the order-q edge
                        # polynomial (vertex + edge dofs) at our points
                        gll_q = h1_nodes_1d(q)
                        B, _ = lagrange_matrices(gll_q, np.asarray(tglob))
                        # B: (p-1, q+1) — columns: q-order nodes in global
                        # direction: [0, 1, interior(1..q-1)] ordering is
                        # positional: gll_q sorted ascending: node 0 = min
                        # endpoint, node q = max endpoint, k interior
                        for j, latt in enumerate(pts):
                            r = latt_index[latt]
                            # endpoint contributions
                            vmin, vmax = (ga, gb) if fwd else (gb, ga)
                            # find slot of each vertex (already added)
                            smin = slots.index(min(ga, gb))
                            smax = slots.index(max(ga, gb))
                            T[r, smin] += B[j, 0]
                            T[r, smax] += B[j, q]
                            for k in range(q - 1):
                                g = int(edge_base[eid] + k)
                                try:
                                    s = slots.index(g)
                                except ValueError:
                                    s = add_slot(g)
                                T[r, s] += B[j, k + 1]
                # interior
                for jj in range(1, p):
                    for ii in range(1, p):
                        g = int(cell_base[e] + (jj - 1) * (p - 1) + (ii - 1))
                        s = add_slot(g)
                        T[latt_index[(ii, jj)], s] = 1.0
                slot_rows.append(slots)
                T_rows.append(T[:, : len(slots)])
            ns = max(len(s) for s in slot_rows)
            S = np.full((len(els), ns), self.ndof, dtype=np.int64)  # pad
            Tb = np.zeros((len(els), nd, ns))
            for i, (sl, Tm) in enumerate(zip(slot_rows, T_rows)):
                S[i, : len(sl)] = sl
                Tb[i, :, : Tm.shape[1]] = Tm
            self.groups[p] = {
                "elems": np.array(els, dtype=np.int64),
                "slots": S, "T": Tb,
            }

    # ------------------------------------------------------------------
    def _build_3d(self):
        """Hex path: edge min-rule (1D traces) + face min-rule (2D tensor
        traces in the face's *canonical frame* — origin at the min global
        vertex id, u-axis toward its smaller-id neighbor, the same
        element-independent convention as the entity-key numbering), with
        demoted-face edge nodes composed through the edges' own orders
        (edge_order ≤ face_order always holds under the min rule)."""
        from ..mesh.mesh import unique_faces
        from .geometry import FACES, REF_VERTS

        mesh = self.mesh
        orders = self.orders
        edges, elem_edge = unique_edges(mesh)
        faces, elem_face = unique_faces(mesh)
        nedge, nface = len(edges), len(faces)

        edge_order = np.full(nedge, 10 ** 9, dtype=np.int64)
        face_order = np.full(nface, 10 ** 9, dtype=np.int64)
        for e in range(mesh.ne):
            for le in range(12):
                eid = elem_edge[e, le]
                edge_order[eid] = min(edge_order[eid], orders[e])
            for lf in range(6):
                fid = elem_face[e, lf]
                face_order[fid] = min(face_order[fid], orders[e])
        self.edge_order, self.face_order = edge_order, face_order

        nv = mesh.nv
        edge_base = np.zeros(nedge + 1, dtype=np.int64)
        np.cumsum(np.maximum(edge_order - 1, 0), out=edge_base[1:])
        edge_base = nv + edge_base
        face_base = np.zeros(nface + 1, dtype=np.int64)
        np.cumsum(np.maximum(face_order - 1, 0) ** 2, out=face_base[1:])
        face_base = edge_base[-1] + face_base
        cell_base = np.zeros(mesh.ne + 1, dtype=np.int64)
        np.cumsum((orders - 1) ** 3, out=cell_base[1:])
        cell_base = face_base[-1] + cell_base
        self.ndof = int(cell_base[-1])
        self._edge_base, self._face_base = edge_base, face_base
        self._edges = edges
        self._faces = faces

        ekey = {tuple(sorted(map(int, r))): i for i, r in enumerate(edges)}
        rv = REF_VERTS[Geometry.CUBE]
        loc_faces = FACES[Geometry.CUBE]
        P2 = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], dtype=np.float64)

        groups: Dict[int, List[int]] = {}
        for e in range(mesh.ne):
            groups.setdefault(int(orders[e]), []).append(e)
        self.groups = {}

        for p, els in groups.items():
            mi = lattice_multi_index(Geometry.CUBE, p)
            nd = len(mi)
            latt_index = {tuple(q): i for i, q in enumerate(mi)}
            corner_latt = [tuple(int(c) * p for c in v) for v in rv]
            gll_p = h1_nodes_1d(p)
            cap = 8 + 12 * (p - 1) + 6 * (p - 1) ** 2 + (p - 1) ** 3 + 8
            slot_rows, T_rows = [], []
            for e in els:
                conn = [int(v) for v in mesh.elements[e]]
                slots: List[int] = []
                slot_of: Dict[int, int] = {}
                T = np.zeros((nd, cap))

                def slot(g):
                    g = int(g)
                    if g not in slot_of:
                        slot_of[g] = len(slots)
                        slots.append(g)
                    return slot_of[g]

                for lv in range(8):
                    T[latt_index[corner_latt[lv]], slot(conn[lv])] = 1.0

                # --- 12 edges (own order: direct; demoted: 1D interp) ---
                for le, (a, b) in enumerate(EDGES[Geometry.CUBE]):
                    eid = elem_edge[e, le]
                    q = int(edge_order[eid])
                    la = np.array(corner_latt[a])
                    lb = np.array(corner_latt[b])
                    pts = [tuple(la + (lb - la) * t // p)
                           for t in range(1, p)]
                    ga, gb = conn[a], conn[b]
                    fwd = ga < gb
                    tloc = gll_p[1:p]
                    tglob = tloc if fwd else 1.0 - tloc
                    if q == p:
                        for k in range(p - 1):
                            g = int(edge_base[eid] + k)
                            idx = k if fwd else (p - 2 - k)
                            T[latt_index[pts[idx]], slot(g)] = 1.0
                    else:
                        gll_q = h1_nodes_1d(q)
                        B, _ = lagrange_matrices(gll_q, np.asarray(tglob))
                        smin = slot(min(ga, gb))
                        smax = slot(max(ga, gb))
                        for j, latt in enumerate(pts):
                            r = latt_index[latt]
                            T[r, smin] += B[j, 0]
                            T[r, smax] += B[j, q]
                            for k in range(q - 1):
                                T[r, slot(edge_base[eid] + k)] += B[j, k + 1]

                # --- 6 faces ---
                for lf, fc in enumerate(loc_faces):
                    fid = elem_face[e, lf]
                    q = int(face_order[fid])
                    G = [conn[c] for c in fc]
                    l0 = np.array(corner_latt[fc[0]])
                    l1 = np.array(corner_latt[fc[1]])
                    l3 = np.array(corner_latt[fc[3]])
                    r0 = int(np.argmin(G))
                    d = 1 if G[(r0 + 1) % 4] < G[(r0 - 1) % 4] else -1
                    cyc = [(r0 + d * k) % 4 for k in range(4)]
                    Gcyc = [G[c] for c in cyc]
                    A2 = P2[cyc[0]]
                    Bax = P2[cyc[1]] - A2
                    Cax = P2[cyc[3]] - A2
                    gll_q = h1_nodes_1d(q)
                    for j in range(1, p):
                        for i in range(1, p):
                            latt = tuple(l0 + (l1 - l0) * i // p
                                         + (l3 - l0) * j // p)
                            r = latt_index[latt]
                            st = np.array([gll_p[i], gll_p[j]]) - A2
                            u = float(Bax @ st)
                            v = float(Cax @ st)
                            if q == p:
                                iu = int(np.argmin(np.abs(gll_p - u)))
                                iv = int(np.argmin(np.abs(gll_p - v)))
                                g = int(face_base[fid]
                                        + (iv - 1) * (q - 1) + (iu - 1))
                                T[r, slot(g)] = 1.0
                                continue
                            Bu, _ = lagrange_matrices(gll_q,
                                                      np.array([u]))
                            Bv, _ = lagrange_matrices(gll_q,
                                                      np.array([v]))
                            Bu, Bv = Bu[0], Bv[0]
                            for bb in range(q + 1):
                                for aa in range(q + 1):
                                    w = Bu[aa] * Bv[bb]
                                    if abs(w) < 1e-14:
                                        continue
                                    on_a = aa in (0, q)
                                    on_b = bb in (0, q)
                                    if on_a and on_b:
                                        k = {(0, 0): 0, (q, 0): 1,
                                             (q, q): 2, (0, q): 3}[(aa, bb)]
                                        T[r, slot(Gcyc[k])] += w
                                    elif on_a or on_b:
                                        if bb == 0:
                                            gA, gB = Gcyc[0], Gcyc[1]
                                            tp = gll_q[aa]
                                        elif bb == q:
                                            gA, gB = Gcyc[3], Gcyc[2]
                                            tp = gll_q[aa]
                                        elif aa == 0:
                                            gA, gB = Gcyc[0], Gcyc[3]
                                            tp = gll_q[bb]
                                        else:
                                            gA, gB = Gcyc[1], Gcyc[2]
                                            tp = gll_q[bb]
                                        eid2 = ekey[tuple(sorted((gA, gB)))]
                                        q2 = int(edge_order[eid2])
                                        tg = tp if gA < gB else 1.0 - tp
                                        B1, _ = lagrange_matrices(
                                            h1_nodes_1d(q2),
                                            np.array([tg]))
                                        B1 = B1[0]
                                        T[r, slot(min(gA, gB))] += w * B1[0]
                                        T[r, slot(max(gA, gB))] += w * B1[q2]
                                        for k in range(q2 - 1):
                                            T[r, slot(edge_base[eid2] + k)] \
                                                += w * B1[k + 1]
                                    else:
                                        g = int(face_base[fid]
                                                + (bb - 1) * (q - 1)
                                                + (aa - 1))
                                        T[r, slot(g)] += w
                # --- interior ---
                for kk in range(1, p):
                    for jj in range(1, p):
                        for ii in range(1, p):
                            g = int(cell_base[e]
                                    + ((kk - 1) * (p - 1) + (jj - 1))
                                    * (p - 1) + (ii - 1))
                            T[latt_index[(ii, jj, kk)], slot(g)] = 1.0
                slot_rows.append(slots)
                T_rows.append(T[:, : len(slots)])
            ns = max(len(s) for s in slot_rows)
            S = np.full((len(els), ns), self.ndof, dtype=np.int64)
            Tb = np.zeros((len(els), nd, ns))
            for i, (sl, Tm) in enumerate(zip(slot_rows, T_rows)):
                S[i, : len(sl)] = sl
                Tb[i, :, : Tm.shape[1]] = Tm
            self.groups[p] = {
                "elems": np.array(els, dtype=np.int64),
                "slots": S, "T": Tb,
            }

    # ------------------------------------------------------------------
    def dof_coords(self) -> np.ndarray:
        """Physical coordinates of every global dof (for BCs/projection)."""
        import numpy as np

        from .estimators import _vertex_basis_at

        X = np.zeros((self.ndof, self.mesh.sdim))
        X[: self.mesh.nv] = self.mesh.vertices
        got = np.zeros(self.ndof, dtype=bool)
        got[: self.mesh.nv] = True
        for p, g in self.groups.items():
            mi = lattice_multi_index(self.mesh.geom, p)
            gll = h1_nodes_1d(p)
            ref = gll[mi]                                # (nd, dim)
            S = _vertex_basis_at(self.mesh.geom, ref)    # (nd, nvpe)
            for i, e in enumerate(g["elems"]):
                quad = self.mesh.vertices[self.mesh.elements[e]]
                phys = S @ quad
                T = g["T"][i]
                slots = g["slots"][i]
                # a dof owned at its own interpolation point: T column has
                # a single 1 in an identity row
                for s, gdof in enumerate(slots):
                    if gdof >= self.ndof or got[gdof]:
                        continue
                    col = T[:, s]
                    ones = np.nonzero(col == 1.0)[0]
                    if len(ones) == 1 and np.count_nonzero(col) == 1:
                        X[gdof] = phys[ones[0]]
                        got[gdof] = True
        return X

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Global dofs on marked boundary attributes."""
        mesh = self.mesh
        if mesh.geom == Geometry.CUBE:
            return self._essential_dofs_3d(bdr_marker)
        edges, elem_edge = unique_edges(mesh)
        ekey = {tuple(sorted(map(int, r))): i for i, r in enumerate(edges)}
        nv = mesh.nv
        edge_base = np.zeros(len(edges) + 1, dtype=np.int64)
        np.cumsum(np.maximum(self.edge_order - 1, 0), out=edge_base[1:])
        edge_base = nv + edge_base
        out = set()
        for row, a in zip(mesh.boundary, mesh.bdr_attributes):
            if bdr_marker is not None and int(a) not in set(bdr_marker):
                continue
            va, vb = int(row[0]), int(row[1])
            out.add(va)
            out.add(vb)
            eid = ekey[tuple(sorted((va, vb)))]
            q = int(self.edge_order[eid])
            for k in range(q - 1):
                out.add(int(edge_base[eid] + k))
        return np.array(sorted(out), dtype=np.int64)

    def _essential_dofs_3d(self, bdr_marker=None) -> np.ndarray:
        mesh = self.mesh
        ekey = {tuple(sorted(map(int, r))): i
                for i, r in enumerate(self._edges)}
        fkey = {tuple(sorted(map(int, r))): i
                for i, r in enumerate(self._faces)}
        out = set()
        for row, a in zip(mesh.boundary, mesh.bdr_attributes):
            if bdr_marker is not None and int(a) not in set(bdr_marker):
                continue
            vs = [int(v) for v in row]
            out.update(vs)
            for i in range(4):
                eid = ekey[tuple(sorted((vs[i], vs[(i + 1) % 4])))]
                q = int(self.edge_order[eid])
                for k in range(q - 1):
                    out.add(int(self._edge_base[eid] + k))
            fid = fkey[tuple(sorted(vs))]
            q = int(self.face_order[fid])
            for k in range((q - 1) ** 2):
                out.add(int(self._face_base[fid] + k))
        return np.array(sorted(out), dtype=np.int64)


def diffusion_operator(sp: VarOrderFESpace, dtype=None):
    """Matrix-free (∇u, ∇v) on the variable-order space.

    Returns (mult, diagonal) closures over per-group batched tensors.
    """
    import jax
    import jax.numpy as jnp

    from ..utils.config import real_t
    from .basis import make_dof_to_quad
    from .geom_factors import compute_geometric_factors
    from .quadinterp import device_basis
    from ..ops import diffusion as dmod

    from .estimators import _vertex_basis_at

    rt = real_t(dtype)
    mesh = sp.mesh
    gops = []
    for p, g in sp.groups.items():
        d2q = make_dof_to_quad(mesh.geom, p)
        db = device_basis(d2q, dtype)
        X = mesh.vertices[mesh.elements[g["elems"]]]     # (neg, nvpe, dim)
        # order-p nodes of each element via the (multi)linear vertex map
        mi = lattice_multi_index(mesh.geom, p)
        gll = h1_nodes_1d(p)
        S = _vertex_basis_at(mesh.geom, gll[mi])         # (nd, nvpe)
        Xe = np.einsum("nv,evd->end", S, X)
        gf = compute_geometric_factors(jnp.asarray(Xe, rt), d2q, dtype)
        qd = dmod.setup_packed(gf, 1.0)
        gops.append({
            "db": db, "qd": qd,
            "slots": jnp.asarray(g["slots"], index_t()),
            "T": jnp.asarray(g["T"], rt),
        })
    ndof = sp.ndof

    def mult(x):
        xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        y = jnp.zeros(ndof + 1, x.dtype)
        for go in gops:
            us = xp[go["slots"]]                          # (neg, ns)
            ue = jnp.einsum("ens,es->en", go["T"], us)
            ye = dmod.apply(go["db"], go["qd"], ue)
            ys = jnp.einsum("ens,en->es", go["T"], ye)
            y = y.at[go["slots"].reshape(-1)].add(ys.reshape(-1))
        return y[:ndof]

    def diagonal():
        y = jnp.zeros(ndof + 1)
        for go in gops:
            de = dmod.diagonal(go["db"], go["qd"])        # (neg, nd)
            # diag of Tᵀ D T ≈ Σ_n T[n,s]² d[n] (exact for diagonal D_e)
            ds = jnp.einsum("ens,en->es", go["T"] ** 2, de)
            y = y.at[go["slots"].reshape(-1)].add(ds.reshape(-1))
        return y[:ndof]

    return mult, diagonal
