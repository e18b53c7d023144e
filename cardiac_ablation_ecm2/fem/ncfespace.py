"""Conforming FE space on a nonconforming (hanging-node) mesh.

Reference analog: the conforming prolongation/restriction ``cP/cR`` that
``FiniteElementSpace`` builds on NC meshes (``fem/fespace.hpp:299-301``) and
applies in ``FormLinearSystem`` as PᵀAP (``fem/bilinearform.cpp:760``).

Design: the broken space is the ordinary key-based FESpace on the refined
mesh (continuous everywhere except across NC interfaces).  Each slave dof
(hanging vertex + slave-edge interior nodes) is an interpolation of the p+1
master-edge dofs; the prolongation is stored as three arrays

    slave_idx (ns,), slave_masters (ns, p+1), slave_w (ns, p+1)

so P and Pᵀ are one gather/segment-scatter each — no sparse matrices.
Transitive (chained) constraints are resolved at build time.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t, real_t
from ..utils.native import encode_rows
from .basis import h1_nodes_1d, lagrange_matrices
from .fespace import (
    FESpace,
    _EDGE,
    _FACE,
    _KEYLEN,
    _VERT,
    _elem_node_keys,
    _meta,
)


def _vert_key(v):
    return [int(v), -1, -1, -1, _meta(_VERT)]


def _edge_key(a, b, t):
    lo, hi = (a, b) if a < b else (b, a)
    return [int(lo), int(hi), -1, -1, _meta(_EDGE, t)]


def _face_key(gf_cyc, uv, p):
    """Canonical quad-face node key: (u, v) in the caller's frame (u along
    corner0→1, v along corner0→3) mapped to the min-id-origin,
    smaller-neighbor-direction frame — must match _elem_node_keys exactly."""
    gf = [int(x) for x in gf_cyc]
    gsort = sorted(gf)
    r = gf.index(min(gf))
    nxt, prv = gf[(r + 1) % 4], gf[(r - 1) % 4]
    d = 1 if nxt < prv else -1
    corner_uv = [(0, 0), (p, 0), (p, p), (0, p)]
    cr = np.array(corner_uv[r])
    eu = (np.array(corner_uv[(r + d) % 4]) - cr) // p
    ev = (np.array(corner_uv[(r - d) % 4]) - cr) // p
    rel = np.array(uv) - cr
    a = int((rel * eu).sum())
    b = int((rel * ev).sum())
    return [gsort[0], gsort[1], gsort[2], gsort[3], _meta(_FACE, a, b)]


def _sigma_on_master(mesh, v, lo, hi):
    return _sigma_pos(mesh, mesh.vertices[v], lo, hi)


def _sigma_pos(mesh, pos, lo, hi):
    plo, phi = mesh.vertices[lo], mesh.vertices[hi]
    return float(np.linalg.norm(pos - plo) / np.linalg.norm(phi - plo))


@dataclasses.dataclass(eq=False)
class NCFESpace:
    nc: object                 # NCQuadMesh or NCHexMesh
    order: int

    def __post_init__(self):
        p = self.order
        self.fes = FESpace(self.nc.mesh, p)
        fes = self.fes
        mesh = self.nc.mesh
        nL = fes.ndof_scalar
        nodes1d = h1_nodes_1d(p)

        # exact entity-key dof lookup: coincident-but-distinct dofs at NC
        # interfaces (hanging vertex vs master-edge node share a position for
        # even p) are disambiguated by entity identity, not coordinates
        main_keys = _elem_node_keys(
            mesh.geom, p, mesh.elements, np.arange(mesh.ne, dtype=np.int64)
        ).reshape(-1, _KEYLEN)

        queries = []
        per_con = []   # (master_slots, [(slave_slot, sigma), …]) per constraint
        for (v, a, b) in self.nc.constraints:
            lo, hi = (a, b) if a < b else (b, a)
            m_slots = [len(queries)]
            queries.append(_vert_key(lo))
            for t in range(1, p):
                m_slots.append(len(queries))
                queries.append(_edge_key(lo, hi, t))
            m_slots.append(len(queries))
            queries.append(_vert_key(hi))

            s_list = [(len(queries), _sigma_on_master(mesh, v, lo, hi))]
            queries.append(_vert_key(v))
            for (c0, c1) in ((a, v), (v, b)):
                clo, chi = (c0, c1) if c0 < c1 else (c1, c0)
                for t in range(1, p):
                    pos = mesh.vertices[clo] + nodes1d[t] * (
                        mesh.vertices[chi] - mesh.vertices[clo]
                    )
                    s_list.append(
                        (len(queries), _sigma_pos(mesh, pos, lo, hi))
                    )
                    queries.append(_edge_key(clo, chi, t))
            per_con.append((m_slots, s_list))

        # --- face constraints (hex meshes): 2D tensor interpolation of all
        # fine dofs on a master face from its (p+1)² dof grid ---
        per_face = []   # (grid_slots[(p+1)²], [(slave_slot, σu, σv), …])
        face_cons = getattr(self.nc, "face_constraints", None)
        half_cons = getattr(self.nc, "half_face_constraints", None)
        if (face_cons is not None and len(face_cons)) or \
                (half_cons is not None and len(half_cons)):
            pos = {}
            for i, pnt in enumerate(mesh.vertices):
                pos.setdefault(tuple(pnt), i)

            def midv(x, y):
                return pos[tuple(0.5 * (mesh.vertices[x] + mesh.vertices[y]))]

            def grid_slots_for(A, B, C, D):
                # master grid keys, index g = u*(p+1)+v; u along A→B, v A→D
                slots = []
                for u in range(p + 1):
                    for v in range(p + 1):
                        if (u, v) == (0, 0):
                            k = _vert_key(A)
                        elif (u, v) == (p, 0):
                            k = _vert_key(B)
                        elif (u, v) == (p, p):
                            k = _vert_key(C)
                        elif (u, v) == (0, p):
                            k = _vert_key(D)
                        elif v == 0:
                            k = _edge_key(A, B, u if A < B else p - u)
                        elif u == p:
                            k = _edge_key(B, C, v if B < C else p - v)
                        elif v == p:
                            k = _edge_key(D, C, u if D < C else p - u)
                        elif u == 0:
                            k = _edge_key(A, D, v if A < D else p - v)
                        else:
                            k = _face_key((A, B, C, D), (u, v), p)
                        slots.append(len(queries))
                        queries.append(k)
                return slots

            def child_face_interiors(ids, P, s_list):
                """Interior nodes of child face ``ids`` with master-frame
                corner params ``P``."""
                P0 = np.array(P[0], dtype=float)
                eu = np.array(P[1], dtype=float) - P0
                ev = np.array(P[3], dtype=float) - P0
                for i in range(1, p):
                    for j in range(1, p):
                        sig = P0 + nodes1d[i] * eu + nodes1d[j] * ev
                        s_list.append(
                            (len(queries), float(sig[0]), float(sig[1]))
                        )
                        queries.append(_face_key(ids, (i, j), p))

        if face_cons is not None and len(face_cons):
            for (c, A, B, C, D) in face_cons:
                c, A, B, C, D = int(c), int(A), int(B), int(C), int(D)
                mAB, mBC = midv(A, B), midv(B, C)
                mCD, mDA = midv(C, D), midv(D, A)
                grid_slots = grid_slots_for(A, B, C, D)

                s_list = [(len(queries), 0.5, 0.5)]
                queries.append(_vert_key(c))
                # interior nodes of the 4 internal child edges
                for (m, su, sv, du, dv) in (
                    (mAB, 0.5, 0.0, 0.0, 0.5),   # mAB → c
                    (mBC, 1.0, 0.5, -0.5, 0.0),  # mBC → c
                    (mCD, 0.5, 1.0, 0.0, -0.5),  # mCD → c
                    (mDA, 0.0, 0.5, 0.5, 0.0),   # mDA → c
                ):
                    for t in range(1, p):
                        f = nodes1d[t]
                        s_list.append(
                            (len(queries), su + f * du, sv + f * dv)
                        )
                        s_t = t if m < c else p - t
                        queries.append(_edge_key(m, c, s_t))
                # interior nodes of the 4 child faces; corner params (σu,σv)
                for ids, P in (
                    ((A, mAB, c, mDA), ((0, 0), (.5, 0), (.5, .5), (0, .5))),
                    ((mAB, B, mBC, c), ((.5, 0), (1, 0), (1, .5), (.5, .5))),
                    ((c, mBC, C, mCD), ((.5, .5), (1, .5), (1, 1), (.5, 1))),
                    ((mDA, c, mCD, D), ((0, .5), (.5, .5), (.5, 1), (0, 1))),
                ):
                    child_face_interiors(ids, P, s_list)
                per_face.append((grid_slots, s_list))

        # --- half-face constraints (anisotropic hex neighbor): the medial
        # edge mE–mF and both half child faces hang on the master face
        # (u along c1→c2, v along c1→c4; mE at (0.5,0), mF at (0.5,1)) ---
        if half_cons is not None and len(half_cons):
            for (mE, mF, A, B, C, D) in half_cons:
                mE, mF = int(mE), int(mF)
                A, B, C, D = int(A), int(B), int(C), int(D)
                grid_slots = grid_slots_for(A, B, C, D)
                s_list = []
                # medial-edge interior nodes at (0.5, t from mE)
                for t in range(1, p):
                    s_list.append((len(queries), 0.5, float(nodes1d[t])))
                    s_t = t if mE < mF else p - t
                    queries.append(_edge_key(mE, mF, s_t))
                # interior nodes of the two half child faces
                child_face_interiors(
                    (A, mE, mF, D), ((0, 0), (.5, 0), (.5, 1), (0, 1)),
                    s_list)
                child_face_interiors(
                    (mE, B, C, mF), ((.5, 0), (1, 0), (1, 1), (.5, 1)),
                    s_list)
                if s_list:
                    per_face.append((grid_slots, s_list))

        # --- tri-face constraints (NC tet meshes, any order): every slave
        # dof interior to a refined master tri face — medial fine-edge
        # nodes and child-face interior nodes — interpolates the master
        # face's full P_p trace grid.  Weights = the master triangle
        # element's nodal basis at the slave's face coordinates
        # (simplex_basis_matrices shares the tet trace node convention:
        # GLL-warped edges, equispaced interiors).
        per_tri = []   # (master_slots[ndl_tri], [(slave_slot, (x, y)), …])
        tri_cons = getattr(self.nc, "tri_face_constraints", None)
        if tri_cons is not None and len(tri_cons) and p >= 2:
            from .basis import lattice_multi_index as _lmi
            from .geometry import Geometry as _G

            mi2 = _lmi(_G.TRIANGLE, p)
            pos3 = {}
            for i, pnt in enumerate(mesh.vertices):
                pos3.setdefault(tuple(pnt), i)

            def midv3(x, y):
                return pos3[tuple(0.5 * (mesh.vertices[x]
                                         + mesh.vertices[y]))]

            def _tri_face_key(g3, bary):
                """Face-interior key matching _elem_node_keys' tri branch:
                sorted globals + barycentric params in the canonical
                (min-id origin, smaller-neighbor direction) frame."""
                gf = [int(x) for x in g3]
                gsort = sorted(gf)
                r = gf.index(min(gf))
                d = 1 if gf[(r + 1) % 3] < gf[(r - 1) % 3] else -1
                a = bary[(r + d) % 3]
                bb = bary[(r - d) % 3]
                return [gsort[0], gsort[1], gsort[2], -1,
                        _meta(_FACE, int(a), int(bb))]

            def _edge_node_key(x, y, t):
                """Interior node t (measured from x) of edge (x, y)."""
                return _edge_key(x, y, t if x < y else p - t)

            for (A, B, C) in tri_cons:
                A, B, C = int(A), int(B), int(C)
                mAB, mBC, mCA = midv3(A, B), midv3(B, C), midv3(C, A)
                # master trace grid in triangle-lattice order (matches the
                # basis column order of simplex_basis_matrices)
                m_slots = []
                for (i, j) in mi2:
                    i, j = int(i), int(j)
                    if (i, j) == (0, 0):
                        k = _vert_key(A)
                    elif (i, j) == (p, 0):
                        k = _vert_key(B)
                    elif (i, j) == (0, p):
                        k = _vert_key(C)
                    elif j == 0:
                        k = _edge_node_key(A, B, i)
                    elif i == 0:
                        k = _edge_node_key(A, C, j)
                    elif i + j == p:
                        k = _edge_node_key(B, C, j)
                    else:
                        k = _tri_face_key((A, B, C), (p - i - j, i, j))
                    m_slots.append(len(queries))
                    queries.append(k)

                # slaves with 2D face coords (A=(0,0), B=(1,0), C=(0,1))
                P = {mAB: np.array([.5, 0.]), mBC: np.array([.5, .5]),
                     mCA: np.array([0., .5])}
                s_list = []
                for (m1, m2) in ((mAB, mBC), (mBC, mCA), (mCA, mAB)):
                    for t in range(1, p):
                        xy = P[m1] + nodes1d[t] * (P[m2] - P[m1])
                        s_list.append((len(queries), tuple(xy)))
                        queries.append(_edge_node_key(m1, m2, t))
                if p >= 3:
                    PA, PB, PC = (np.array([0., 0.]), np.array([1., 0.]),
                                  np.array([0., 1.]))
                    for (g3, c3) in (
                        ((A, mAB, mCA), (PA, P[mAB], P[mCA])),
                        ((mAB, B, mBC), (P[mAB], PB, P[mBC])),
                        ((mCA, mBC, C), (P[mCA], P[mBC], PC)),
                        ((mAB, mBC, mCA), (P[mAB], P[mBC], P[mCA])),
                    ):
                        for (i, j) in mi2:
                            i, j = int(i), int(j)
                            if i == 0 or j == 0 or i + j == p:
                                continue
                            b0, b1, b2 = p - i - j, i, j
                            xy = (b0 * c3[0] + b1 * c3[1] + b2 * c3[2]) / p
                            s_list.append((len(queries), tuple(xy)))
                            queries.append(_tri_face_key(g3, (b0, b1, b2)))
                per_tri.append((m_slots, s_list))

        if queries:
            _, _, qids = encode_rows(
                main_keys, np.asarray(queries, dtype=np.int64)
            )
            assert (qids >= 0).all(), "NC constraint dof lookup failed"
        rows = {}                     # slave L-dof -> [(master L-dof, w)]
        for (m_slots, s_list) in per_con:
            masters = [int(qids[i]) for i in m_slots]
            for (slot, sigma) in s_list:
                s = int(qids[slot])
                W, _ = lagrange_matrices(nodes1d, np.array([sigma]))
                rows[s] = list(zip(masters, W[0]))
        for (grid_slots, s_list) in per_face:
            masters = [int(qids[i]) for i in grid_slots]
            for (slot, su, sv) in s_list:
                s = int(qids[slot])
                Wu, _ = lagrange_matrices(nodes1d, np.array([su]))
                Wv, _ = lagrange_matrices(nodes1d, np.array([sv]))
                w2 = np.outer(Wu[0], Wv[0]).reshape(-1)   # g = u*(p+1)+v
                rows[s] = [
                    (masters[g], w2[g])
                    for g in range(len(masters)) if abs(w2[g]) > 1e-14
                ]
        for (m_slots, s_list) in per_tri:
            from .basis import simplex_basis_matrices as _sbm
            from .geometry import Geometry as _G

            masters = [int(qids[i]) for i in m_slots]
            pts = np.array([xy for (_slot, xy) in s_list], dtype=np.float64)
            Btr, _ = _sbm(_G.TRIANGLE, p, pts)
            Btr = np.asarray(Btr)
            for row_i, (slot, _xy) in enumerate(s_list):
                s = int(qids[slot])
                rows[s] = [
                    (masters[g], Btr[row_i, g])
                    for g in range(len(masters))
                    if abs(Btr[row_i, g]) > 1e-14
                ]

        # resolve chained constraints (slave's master itself slave)
        for _ in range(32):
            changed = False
            for s, terms in list(rows.items()):
                if any(m in rows for m, _ in terms):
                    out = {}
                    for m, w in terms:
                        if m in rows:
                            for m2, w2 in rows[m]:
                                out[m2] = out.get(m2, 0.0) + w * w2
                        else:
                            out[m] = out.get(m, 0.0) + w
                    rows[s] = list(out.items())
                    changed = True
            if not changed:
                break

        ns = len(rows)
        slave_ids = np.array(sorted(rows), dtype=np.int64)
        width = max((len(rows[s]) for s in slave_ids), default=1)
        sm = np.zeros((ns, width), dtype=np.int64)
        sw = np.zeros((ns, width))
        for i, s in enumerate(slave_ids):
            for j, (m, w) in enumerate(rows[s]):
                sm[i, j] = m
                sw[i, j] = w

        is_slave = np.zeros(nL, dtype=bool)
        is_slave[slave_ids] = True
        conf_of_L = np.full(nL, -1, dtype=np.int64)
        conf_of_L[~is_slave] = np.arange((~is_slave).sum())
        self.ndof_conf = int((~is_slave).sum())
        self.L_of_conf = np.nonzero(~is_slave)[0]

        self._slave_idx = jnp.asarray(slave_ids, index_t())
        self._slave_masters = jnp.asarray(conf_of_L[sm], index_t())
        self._slave_w = jnp.asarray(sw, real_t())
        self._L_of_conf = jnp.asarray(self.L_of_conf, index_t())
        self._conf_of_L = conf_of_L
        self.n_slaves = ns

    # ------------------------------------------------------------------
    def prolongate(self, uc: jnp.ndarray) -> jnp.ndarray:
        """Conforming → broken L-vector (cP analog)."""
        uL = jnp.zeros(self.fes.ndof_scalar, dtype=uc.dtype)
        uL = uL.at[self._L_of_conf].set(uc)
        sv = jnp.sum(uc[self._slave_masters] * self._slave_w, axis=1)
        return uL.at[self._slave_idx].set(sv)

    def restrict_t(self, vL: jnp.ndarray) -> jnp.ndarray:
        """Pᵀ: broken L-residual → conforming (exact adjoint)."""
        vc = vL[self._L_of_conf]
        contrib = vL[self._slave_idx][:, None] * self._slave_w
        return vc.at[self._slave_masters.reshape(-1)].add(contrib.reshape(-1))

    def constrained_operator(self, A_L):
        """A_C(x) = Pᵀ A_L(P x) — the PᵀAP conforming assembly."""

        def mult(x):
            return self.restrict_t(A_L(self.prolongate(x)))

        return mult

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        essL = self.fes.essential_dofs(bdr_marker)
        conf = self._conf_of_L[essL]
        return np.unique(conf[conf >= 0]).astype(np.int32)

    @property
    def dof_coords(self) -> np.ndarray:
        return self.fes.dof_coords[self.L_of_conf]
