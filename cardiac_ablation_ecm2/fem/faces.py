"""Face data for DG methods: interior/boundary face quadrature, per-side
basis evaluation, and outward normals.

Reference analog: the face-restriction machinery (``L2FaceRestriction``,
``fem/restriction.hpp:455``) + ``FaceElementTransformations``
(``fem/eltrans.hpp:749``) + ``FaceQuadratureInterpolator``.

Design: all orientation logic runs host-side at setup.  Each face
gets a canonical quadrature frame (derived from its sorted global vertex ids,
the same canonicalization used for dof numbering); for each adjacent element
we precompute the dense matrix ``B[f, q, n]`` evaluating that element's
volume basis at the face quadrature points.  The device-side face apply is
then two batched matmuls + a segment-sum scatter — no orientation branches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .basis import h1_nodes_1d, lagrange_matrices, lattice_multi_index, simplex_basis_matrices
from .geometry import DIMENSION, FACES, FACE_GEOM, Geometry, IS_TENSOR, REF_VERTS
from .intrules import gauss_legendre_1d, simplex_rule, tensor_rule


@dataclasses.dataclass(eq=False)
class FaceData:
    """Host-side numpy face tables (converted to device arrays by users)."""

    # interior faces
    elem0: np.ndarray      # (nfi,)
    elem1: np.ndarray      # (nfi,)
    B0: np.ndarray         # (nfi, nq_f, nd) basis of elem0 at face qpts
    B1: np.ndarray         # (nfi, nq_f, nd)
    normal: np.ndarray     # (nfi, nq_f, dim) unit, outward from elem0
    wdet: np.ndarray       # (nfi, nq_f) surface measure × quad weight
    xq: np.ndarray         # (nfi, nq_f, dim) physical face quad points
    # boundary faces
    b_elem: np.ndarray     # (nfb,)
    b_B: np.ndarray        # (nfb, nq_f, nd)
    b_normal: np.ndarray   # (nfb, nq_f, dim) outward
    b_wdet: np.ndarray     # (nfb, nq_f)
    b_xq: np.ndarray       # (nfb, nq_f, dim)
    b_attr: np.ndarray     # (nfb,)
    # physical basis gradients at face qpts (filled when with_gradients=True;
    # needed by DG diffusion / interior penalty)
    G0: np.ndarray = None  # (nfi, nq_f, nd, dim)
    G1: np.ndarray = None
    b_G: np.ndarray = None  # (nfb, nq_f, nd, dim)
    h0: np.ndarray = None   # (nfi,) elem0 size normal to face (penalty scale)
    h1: np.ndarray = None
    b_h: np.ndarray = None


def _face_quad(fgeom: Geometry, nq1d: int):
    if fgeom == Geometry.SEGMENT:
        x, w = gauss_legendre_1d(nq1d)
        return x[:, None].copy(), w.copy()
    if fgeom == Geometry.SQUARE:
        return tensor_rule(2, nq1d)
    if fgeom == Geometry.TRIANGLE:
        return simplex_rule(2, 2 * nq1d - 1)
    raise ValueError(fgeom)


def _eval_volume_basis(geom: Geometry, p: int, pts: np.ndarray) -> np.ndarray:
    """Volume nodal basis at arbitrary reference points → (npts, nd)."""
    if IS_TENSOR.get(geom, False):
        x1 = h1_nodes_1d(p)
        dim = DIMENSION[geom]
        per = [lagrange_matrices(x1, pts[:, d])[0] for d in range(dim)]
        B = per[0]
        if dim >= 2:
            B = np.einsum("qi,qj->qji", per[0], per[1]).reshape(len(pts), -1)
        if dim == 3:
            B = np.einsum("qi,qj,qk->qkji", per[0], per[1], per[2]).reshape(
                len(pts), -1
            )
        return B
    B, _ = simplex_basis_matrices(geom, p, pts)
    return B


def _eval_volume_basis_grad(geom: Geometry, p: int, pts: np.ndarray) -> np.ndarray:
    """Reference gradients of the volume basis at points → (npts, nd, dim)."""
    dim = DIMENSION[geom]
    if IS_TENSOR.get(geom, False):
        x1 = h1_nodes_1d(p)
        vals = [lagrange_matrices(x1, pts[:, d]) for d in range(dim)]
        out = np.zeros((len(pts), (p + 1) ** dim, dim))
        for dd in range(dim):
            per = [vals[d][1] if d == dd else vals[d][0] for d in range(dim)]
            if dim == 1:
                out[:, :, dd] = per[0]
            elif dim == 2:
                out[:, :, dd] = np.einsum(
                    "qi,qj->qji", per[0], per[1]
                ).reshape(len(pts), -1)
            else:
                out[:, :, dd] = np.einsum(
                    "qi,qj,qk->qkji", per[0], per[1], per[2]
                ).reshape(len(pts), -1)
        return out
    _, G = simplex_basis_matrices(geom, p, pts)
    return G


def build_face_data(mesh, p: int, nq1d: Optional[int] = None,
                    nodes: str = "l2", with_gradients: bool = False) -> FaceData:
    """Assemble all face tables for an order-p (L2) space on ``mesh``.

    ``with_gradients``: also compute per-side *physical* basis gradients at
    the face quadrature points and normal element sizes (DG diffusion)."""
    geom = mesh.geom
    dim = mesh.dim
    fgeom = FACE_GEOM[geom]
    if nq1d is None:
        nq1d = p + 2
    fq, fw = _face_quad(fgeom, nq1d)            # canonical face rule
    nq_f = len(fw)

    loc_faces = FACES[geom]
    latt_v = REF_VERTS[geom]                    # (nv_el, dim) float
    elems = mesh.elements
    ne = mesh.ne

    # per-element corner coordinates.  For ordinary meshes these equal
    # mesh.vertices[conn]; for periodic meshes (identified vertices with
    # explicit order-1 nodes) the element's OWN copy of each corner differs
    # from the shared vertex position — face geometry must use the former.
    if mesh.nodes is not None and mesh.nodes_order == 1:
        X1 = mesh.nodes                          # (ne, nv_lex, sdim)
        mi1 = lattice_multi_index(geom, 1)
        lex_of = {tuple(row): i for i, row in enumerate(mi1)}
        latt_i = np.rint(latt_v).astype(np.int64)
        corner_coords = np.stack(
            [X1[:, lex_of[tuple(latt_i[v])]] for v in range(len(latt_v))],
            axis=1,
        )                                        # (ne, nv_el, sdim)
    else:
        corner_coords = mesh.vertices[elems]

    # gather (elem, local_face) incidences keyed by sorted vertex tuple
    from collections import defaultdict

    incid = defaultdict(list)
    for lf, fverts in enumerate(loc_faces):
        fv = elems[:, list(fverts)]
        key = np.sort(fv, axis=1)
        for e in range(ne):
            incid[tuple(key[e])].append((e, lf))

    bdr_lookup = {}
    for i, bconn in enumerate(mesh.boundary):
        bdr_lookup[tuple(sorted(bconn.tolist()))] = i

    int_rows, bdr_rows = [], []
    for key, lst in incid.items():
        if len(lst) == 2:
            int_rows.append((key, lst[0], lst[1]))
        elif len(lst) == 1:
            attr = mesh.bdr_attributes[bdr_lookup[key]] if key in bdr_lookup else 0
            bdr_rows.append((key, lst[0], attr))
        else:
            raise ValueError("nonmanifold face")

    # canonical frame for a face: origin = corner with min global vertex id,
    # first axis toward its smaller cyclic neighbor (same rule as fespace)
    def face_ref_points(e, lf):
        """Element-reference coords of the canonical face quad points, plus
        the face corner coords for geometry."""
        fverts = loc_faces[lf]
        k = len(fverts)
        gids = elems[e, list(fverts)]
        r = int(np.argmin(gids))
        d = 1 if gids[(r + 1) % k] < gids[(r - 1) % k] else -1
        # canonical corners in cyclic order starting at r, direction d
        cyc = [(r + d * i) % k for i in range(k)]
        corners = latt_v[[fverts[c] for c in cyc]]      # (k, dim) elem-ref
        if k == 4 or (k == 2):
            # bilinear (segment/quad) map from canonical coords
            if k == 2:
                a = fq[:, 0:1]
                pts = corners[0] * (1 - a) + corners[1] * a
            else:
                a, b = fq[:, 0:1], fq[:, 1:2]
                pts = (
                    corners[0] * (1 - a) * (1 - b)
                    + corners[1] * a * (1 - b)
                    + corners[2] * a * b
                    + corners[3] * (1 - a) * b
                )
        else:  # triangle
            a, b = fq[:, 0:1], fq[:, 1:2]
            pts = corners[0] * (1 - a - b) + corners[1] * a + corners[2] * b
        return pts

    nd = len(lattice_multi_index(geom, p))
    nfi = len(int_rows)
    B0 = np.zeros((nfi, nq_f, nd))
    B1 = np.zeros((nfi, nq_f, nd))
    e0s = np.zeros(nfi, dtype=np.int64)
    e1s = np.zeros(nfi, dtype=np.int64)
    nrm = np.zeros((nfi, nq_f, dim))
    wdt = np.zeros((nfi, nq_f))
    xqs = np.zeros((nfi, nq_f, dim))

    cent = corner_coords.mean(axis=1)

    def canonical_face_phys(key, e, lf):
        """Physical points / normal / measure for the canonical face frame."""
        fverts = loc_faces[lf]
        k = len(fverts)
        gids = elems[e, list(fverts)]
        r = int(np.argmin(gids))
        d = 1 if gids[(r + 1) % k] < gids[(r - 1) % k] else -1
        cyc = [(r + d * i) % k for i in range(k)]
        V = np.stack([corner_coords[e, fverts[c]] for c in cyc])  # (k, sdim)
        if k == 2:
            a = fq[:, 0:1]
            x = V[0] * (1 - a) + V[1] * a
            t = np.broadcast_to(V[1] - V[0], x.shape)
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        elif k == 4:
            a, b = fq[:, 0:1], fq[:, 1:2]
            x = (V[0] * (1 - a) * (1 - b) + V[1] * a * (1 - b)
                 + V[2] * a * b + V[3] * (1 - a) * b)
            ta = (V[1] - V[0]) * (1 - b) + (V[2] - V[3]) * b
            tb = (V[3] - V[0]) * (1 - a) + (V[2] - V[1]) * a
            n = np.cross(ta, tb)
        else:  # triangle
            a, b = fq[:, 0:1], fq[:, 1:2]
            x = V[0] * (1 - a - b) + V[1] * a + V[2] * b
            ta = np.broadcast_to(V[1] - V[0], x.shape)
            tb = np.broadcast_to(V[2] - V[0], x.shape)
            n = np.cross(ta, tb)
        mag = np.linalg.norm(n, axis=1)
        return x, n / mag[:, None], mag

    from .fespace import _q1_eval_matrix

    def _geom_shape(pts):
        """Linear geometry shape functions (affine for simplices,
        multilinear for tensor cells) — _q1_eval_matrix is tensor-only."""
        if geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON):
            B, _ = simplex_basis_matrices(geom, 1, np.atleast_2d(pts))
            return B
        return _q1_eval_matrix(geom, np.atleast_2d(pts))

    def phys_grad_and_h(e, ref_pts, Gref, face_area):
        """J^{-T} Gref at each point + normal element size vol/area."""
        V = corner_coords[e]                          # (nv_el, sdim)
        # Q1 Jacobian at the ref points via finite differences of the Q1 map
        # (exact for multilinear within machine eps using central diffs)
        out = np.zeros_like(Gref)
        h = 1e-6
        vol = None
        for iq, xi in enumerate(ref_pts):
            J = np.zeros((mesh.sdim, dim))
            for d in range(dim):
                xp = xi.copy(); xp[d] += h
                xm = xi.copy(); xm[d] -= h
                J[:, d] = (
                    (_geom_shape(xp[None])[0] - _geom_shape(xm[None])[0]) @ V
                ) / (2 * h)
            Jinv = np.linalg.inv(J)
            out[iq] = Gref[iq] @ Jinv
        # element volume via centroid Jacobian (exact for parallelepipeds,
        # adequate penalty scale otherwise)
        c = np.full(dim, 0.5) if geom in (Geometry.SQUARE, Geometry.CUBE) \
            else np.full(dim, 1.0 / (dim + 1))
        Jc = np.zeros((mesh.sdim, dim))
        for d in range(dim):
            xp = c.copy(); xp[d] += h
            xm = c.copy(); xm[d] -= h
            Jc[:, d] = ((_geom_shape(xp[None])[0]
                         - _geom_shape(xm[None])[0]) @ V) / (2 * h)
        refvol = 1.0 if geom in (Geometry.SQUARE, Geometry.CUBE) else (
            0.5 if geom == Geometry.TRIANGLE else 1.0 / 6.0
        )
        vol = abs(np.linalg.det(Jc)) * refvol
        return out, vol / face_area

    if with_gradients:
        G0a = np.zeros((nfi, nq_f, nd, dim))
        G1a = np.zeros((nfi, nq_f, nd, dim))
        h0a = np.zeros(nfi)
        h1a = np.zeros(nfi)

    for i, (key, (e0, lf0), (e1, lf1)) in enumerate(int_rows):
        r0 = face_ref_points(e0, lf0)
        r1 = face_ref_points(e1, lf1)
        B0[i] = _eval_volume_basis(geom, p, r0)
        B1[i] = _eval_volume_basis(geom, p, r1)
        e0s[i], e1s[i] = e0, e1
        x, n, mag = canonical_face_phys(key, e0, lf0)
        # orient outward from e0
        sgn = np.sign((x.mean(axis=0) - cent[e0]) @ n.mean(axis=0))
        nrm[i] = n * (sgn if sgn != 0 else 1.0)
        wdt[i] = fw * mag
        xqs[i] = x
        if with_gradients:
            area = float(np.sum(fw * mag))
            G0a[i], h0a[i] = phys_grad_and_h(
                e0, r0, _eval_volume_basis_grad(geom, p, r0), area
            )
            G1a[i], h1a[i] = phys_grad_and_h(
                e1, r1, _eval_volume_basis_grad(geom, p, r1), area
            )

    nfb = len(bdr_rows)
    bB = np.zeros((nfb, nq_f, nd))
    be = np.zeros(nfb, dtype=np.int64)
    bn = np.zeros((nfb, nq_f, dim))
    bw = np.zeros((nfb, nq_f))
    bx = np.zeros((nfb, nq_f, dim))
    battr = np.zeros(nfb, dtype=np.int64)
    if with_gradients:
        bGa = np.zeros((nfb, nq_f, nd, dim))
        bha = np.zeros(nfb)

    for i, (key, (e0, lf0), attr) in enumerate(bdr_rows):
        r0 = face_ref_points(e0, lf0)
        bB[i] = _eval_volume_basis(geom, p, r0)
        be[i] = e0
        x, n, mag = canonical_face_phys(key, e0, lf0)
        sgn = np.sign((x.mean(axis=0) - cent[e0]) @ n.mean(axis=0))
        bn[i] = n * (sgn if sgn != 0 else 1.0)
        bw[i] = fw * mag
        bx[i] = x
        battr[i] = attr
        if with_gradients:
            area = float(np.sum(fw * mag))
            bGa[i], bha[i] = phys_grad_and_h(
                e0, r0, _eval_volume_basis_grad(geom, p, r0), area
            )

    fd = FaceData(
        elem0=e0s, elem1=e1s, B0=B0, B1=B1, normal=nrm, wdet=wdt, xq=xqs,
        b_elem=be, b_B=bB, b_normal=bn, b_wdet=bw, b_xq=bx, b_attr=battr,
    )
    if with_gradients:
        fd.G0, fd.G1, fd.h0, fd.h1 = G0a, G1a, h0a, h1a
        fd.b_G, fd.b_h = bGa, bha
    return fd
