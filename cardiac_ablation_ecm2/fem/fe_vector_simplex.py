"""Arbitrary-order Nédélec H(curl) / Raviart-Thomas H(div) on simplices
(triangles, tetrahedra) with true dof transformations.

Reference analog: ``ND_TetrahedronElement`` / ``RT_TetrahedronElement``
(``fem/fe/fe_nd.hpp:173``, ``fe_rt.cpp``) + ``DofTransformation``
(``fem/doftrans.hpp:141``) — the orientation machinery that tensor-product
elements avoid (there everything reduces to permutation+sign) but triangular
faces cannot.

Design — no per-element transformation objects:

* The reference basis is **dual to moment functionals** (edge tangential
  moments against Legendre, face tangential/normal moments against monomial
  fields in the face's vertex frame, interior moments).  Moment dofs make the
  orientation action *linear and local per entity*: re-ordering an entity's
  vertices transforms its dof block by a small constant matrix.
* Global dofs use each entity's **canonical frame** (vertices sorted by
  global id).  Per element, the local→canonical relation is an orientation
  code: 1 bit per edge, a permutation in S₃ per triangular face.
* The E-gather then becomes gather + **batched block matmuls** with one of
  finitely many precomputed matrices (2 per edge family, 6 per face family)
  — batched matmuls, no data-dependent control flow.

Space identities::

  ND_k = (P_{k-1})^d ⊕ S_k,  S_k = {p ∈ (homog P_k)^d : p·x = 0}
  RT_q = (P_{q-1})^d ⊕ x·(homog P_{q-1})

Polynomials are exact dense coefficient tensors (numpy f64); the spanning
set of S_k is SVD-reduced to a basis.  All Vandermonde / orientation
matrices are built host-side once per (geometry, order).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

from .geometry import DIMENSION, EDGES, FACES, Geometry, REF_VERTS
from .intrules import gauss_legendre_1d, simplex_rule

# ---------------------------------------------------------------------------
# dense-tensor polynomial algebra: coeff[i,j(,k)] · x^i y^j (z^k)
# ---------------------------------------------------------------------------


def _pzeros(dim, K):
    return np.zeros((K,) * dim)


def _pmono(dim, K, alpha):
    c = _pzeros(dim, K)
    c[tuple(alpha)] = 1.0
    return c


def _pdiff(c, axis):
    K = c.shape[0]
    out = np.zeros_like(c)
    idx = np.arange(1, K)
    sl_src = [slice(None)] * c.ndim
    sl_dst = [slice(None)] * c.ndim
    sl_src[axis] = slice(1, None)
    sl_dst[axis] = slice(0, K - 1)
    shape = [1] * c.ndim
    shape[axis] = K - 1
    out[tuple(sl_dst)] = c[tuple(sl_src)] * idx.reshape(shape)
    return out


def _pmulx(c, axis):
    K = c.shape[0]
    out = np.zeros_like(c)
    sl_src = [slice(None)] * c.ndim
    sl_dst = [slice(None)] * c.ndim
    sl_src[axis] = slice(0, K - 1)
    sl_dst[axis] = slice(1, None)
    out[tuple(sl_dst)] = c[tuple(sl_src)]
    return out


def _peval(c, pts):
    """Evaluate scalar poly at pts (n, dim)."""
    K = c.shape[0]
    dim = c.ndim
    pw = [pts[:, d, None] ** np.arange(K)[None, :] for d in range(dim)]
    if dim == 2:
        return np.einsum("ij,ni,nj->n", c, pw[0], pw[1])
    return np.einsum("ijk,ni,nj,nk->n", c, pw[0], pw[1], pw[2])


def _vcurl(comps):
    """Curl of a vector poly (list of dim coeff tensors).  3D → 3 comps;
    2D → scalar curl (1 comp)."""
    if len(comps) == 3:
        return [
            _pdiff(comps[2], 1) - _pdiff(comps[1], 2),
            _pdiff(comps[0], 2) - _pdiff(comps[2], 0),
            _pdiff(comps[1], 0) - _pdiff(comps[0], 1),
        ]
    return [_pdiff(comps[1], 0) - _pdiff(comps[0], 1)]


def _vdiv(comps):
    out = None
    for d, c in enumerate(comps):
        t = _pdiff(c, d)
        out = t if out is None else out + t
    return [out]


def _monomials_upto(dim, deg):
    """Exponent tuples with |alpha| <= deg, graded-lex order."""
    out = []
    for total in range(deg + 1):
        for alpha in itertools.product(range(total + 1), repeat=dim):
            if sum(alpha) == total:
                out.append(alpha)
    return out


def _monomials_exact(dim, deg):
    return [a for a in _monomials_upto(dim, deg) if sum(a) == deg]


# ---------------------------------------------------------------------------
# spanning sets
# ---------------------------------------------------------------------------


def _nd_span(dim, k):
    """Vector polys spanning ND_k; S_k part SVD-reduced to a basis."""
    K = k + 2
    span = []
    for alpha in _monomials_upto(dim, k - 1):
        for d in range(dim):
            comps = [_pzeros(dim, K) for _ in range(dim)]
            comps[d] = _pmono(dim, K, alpha)
            span.append(comps)
    # S_k spanning: m·(x_j e_i − x_i e_j), m homogeneous of degree k−1
    sk = []
    pairs = [(0, 1)] if dim == 2 else [(0, 1), (0, 2), (1, 2)]
    for alpha in _monomials_exact(dim, k - 1):
        m = _pmono(dim, K, alpha)
        for (i, j) in pairs:
            comps = [_pzeros(dim, K) for _ in range(dim)]
            comps[i] = _pmulx(m, j)
            comps[j] = -_pmulx(m, i)
            sk.append(comps)
    # target rank of S_k = dim ND_k − dim (P_{k-1})^d
    rank = dim_nd(dim, k) - len(span)
    if sk and rank > 0:
        A = np.stack([np.concatenate([c.ravel() for c in comps])
                      for comps in sk], axis=1)
        U, s, Vt = np.linalg.svd(A, full_matrices=False)
        assert (s[:rank] > 1e-9).all(), s
        basis_flat = U[:, :rank] * s[:rank]
        n = sk[0][0].size
        for col in range(rank):
            flat = basis_flat[:, col]
            comps = [flat[d * n:(d + 1) * n].reshape(sk[0][0].shape)
                     for d in range(dim)]
            span.append(comps)
    return span


def _rt_span(dim, q):
    """Vector polys spanning RT_q = (P_{q-1})^d ⊕ x·homog_{q-1}."""
    K = q + 2
    span = []
    for alpha in _monomials_upto(dim, q - 1):
        for d in range(dim):
            comps = [_pzeros(dim, K) for _ in range(dim)]
            comps[d] = _pmono(dim, K, alpha)
            span.append(comps)
    for alpha in _monomials_exact(dim, q - 1):
        m = _pmono(dim, K, alpha)
        comps = [_pmulx(m, d) for d in range(dim)]
        span.append(comps)
    return span


def dim_nd(dim, k):
    if dim == 2:
        return k * (k + 2)
    return k * (k + 2) * (k + 3) // 2


def dim_rt(dim, q):
    if dim == 2:
        return q * (q + 2)
    return 3 * _ncomb(q + 2, 3) + _ncomb(q + 1, 2)


def _ncomb(n, r):
    import math

    return math.comb(n, r) if n >= r else 0


# ---------------------------------------------------------------------------
# functionals (reference element, parametrizable by entity vertex order)
# ---------------------------------------------------------------------------


def _legendre01(i, s):
    """Shifted Legendre P_i on [0,1]."""
    x = 2.0 * s - 1.0
    return np.polynomial.legendre.legval(x, [0.0] * i + [1.0])


def _edge_moments(span, va, vb, k, nq=16):
    """∫_e u·(vb−va) L_i(s) ds, i=0..k−1, edge x(s)=va+s(vb−va)."""
    xg, wg = gauss_legendre_1d(nq)
    pts = va[None, :] + xg[:, None] * (vb - va)[None, :]
    t = vb - va
    rows = []
    vals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in span],
        axis=0,
    )                                                   # (nspan, nq, dim)
    ut = vals @ t                                       # (nspan, nq)
    for i in range(k):
        L = _legendre01(i, xg)
        rows.append((ut * (L * wg)[None, :]).sum(axis=1))
    return rows                                          # list of (nspan,)


def _tri_param(v0, v1, v2, pts2):
    return (v0[None, :] + pts2[:, 0:1] * (v1 - v0)[None, :]
            + pts2[:, 1:2] * (v2 - v0)[None, :])


def _face_moments_nd(span, v0, v1, v2, deg, order_q=None):
    """ND tri-face moments: ∫_T u·(P_m τ) dξdη for P_m monomials of degree
    ≤ deg and τ ∈ {v1−v0, v2−v0}.  Returns list of rows (nspan,)."""
    if deg < 0:
        return []
    pts2, w2 = simplex_rule(2, 2 * (deg + 5))
    pts = _tri_param(v0, v1, v2, pts2)
    vals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in span],
        axis=0,
    )                                                   # (nspan, nq, 3)
    rows = []
    for alpha in _monomials_upto(2, deg):
        P = pts2[:, 0] ** alpha[0] * pts2[:, 1] ** alpha[1]
        for tau in (v1 - v0, v2 - v0):
            ut = vals @ tau
            rows.append((ut * (P * w2)[None, :]).sum(axis=1))
    return rows


def _face_moments_rt(span, v0, v1, v2, deg, order_q=None):
    """RT tri-face moments: ∫_T (u·n) P_m dξdη, n = (v1−v0)×(v2−v0)."""
    if deg < 0:
        return []
    pts2, w2 = simplex_rule(2, 2 * (deg + 5))
    pts = _tri_param(v0, v1, v2, pts2)
    n = np.cross(v1 - v0, v2 - v0)
    vals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in span],
        axis=0,
    )
    un = vals @ n
    rows = []
    for alpha in _monomials_upto(2, deg):
        P = pts2[:, 0] ** alpha[0] * pts2[:, 1] ** alpha[1]
        rows.append((un * (P * w2)[None, :]).sum(axis=1))
    return rows


def _edge_moments_rt2d(span, va, vb, deg):
    """RT 2D 'face' (=edge) moments: ∫ (u·n) P_i(s) ds, n = rot90(vb−va)."""
    xg, wg = gauss_legendre_1d(16)
    pts = va[None, :] + xg[:, None] * (vb - va)[None, :]
    t = vb - va
    n = np.array([t[1], -t[0]])
    vals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in span],
        axis=0,
    )
    un = vals @ n
    rows = []
    for i in range(deg + 1):
        L = _legendre01(i, xg)
        rows.append((un * (L * wg)[None, :]).sum(axis=1))
    return rows


def _interior_moments(span, dim, deg):
    """∫_ref u·(P_m e_d) dV for |m| ≤ deg."""
    if deg < 0:
        return []
    pts, w = simplex_rule(dim, 2 * (deg + 4) + 2)
    vals = np.stack(
        [np.stack([_peval(c, comps_pts) for c in comps], axis=1)
         for comps, comps_pts in ((s, pts) for s in span)],
        axis=0,
    )                                                   # (nspan, nq, dim)
    rows = []
    for alpha in _monomials_upto(dim, deg):
        P = np.ones(len(pts))
        for d in range(dim):
            P = P * pts[:, d] ** alpha[d]
        for d in range(dim):
            rows.append((vals[:, :, d] * (P * w)[None, :]).sum(axis=1))
    return rows


# ---------------------------------------------------------------------------
# reference element: Vandermonde-dual basis + quadrature evaluation
# ---------------------------------------------------------------------------


def _perm_s3():
    """Fixed enumeration of S3 (permutations of 3 slots)."""
    return [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


@functools.lru_cache(maxsize=None)
def simplex_vec_element(geom: Geometry, kind: str, order: int, qdeg: int):
    """Build the reference ND_k / RT_q simplex element.

    Returns a dict with:
      pts, w          — volume quadrature (degree qdeg)
      B (nq, nd, dim) — basis values;  D (nq, nd, m) — curl (m=1 2D /3 3D)
                        for ND, divergence (m=1) for RT
      n_edge, n_face, n_int — dof block sizes per entity
      edge_T (2, n_edge, n_edge)   — [identity, reversal] maps F^or = T F^ref
      face_T (6, n_face, n_face)   — per S3 permutation (3D only)
    All matrices act on a single entity's dof block; the *inverses* needed by
    the gather path are returned as edge_Ti / face_Ti.
    """
    dim = DIMENSION[geom]
    rv = REF_VERTS[geom].astype(np.float64)
    k = order
    if kind == "nd":
        span = _nd_span(dim, k)
        n_edge = k
        face_deg = k - 2
        n_face = 2 * len(_monomials_upto(2, face_deg)) if (
            dim == 3 and face_deg >= 0
        ) else 0
        int_deg = (k - 3) if dim == 3 else (k - 2)
        n_int = dim * len(_monomials_upto(dim, int_deg)) if int_deg >= 0 else 0
        ndof = dim_nd(dim, k)
    else:
        q = order
        span = _rt_span(dim, q)
        if dim == 2:
            n_edge = q                      # deg q−1 moments per edge
            n_face = 0
            int_deg = q - 2
        else:
            n_edge = 0
            face_deg = q - 1
            n_face = len(_monomials_upto(2, face_deg))
            int_deg = q - 2
        n_int = dim * len(_monomials_upto(dim, int_deg)) if int_deg >= 0 else 0
        ndof = dim_rt(dim, q)

    # ---- reference functionals (local entity order) --------------------
    rows = []
    edges = EDGES[geom]
    faces = FACES[geom] if dim == 3 else ()
    if kind == "nd":
        for (a, b) in edges:
            rows += _edge_moments(span, rv[a], rv[b], k)
        if dim == 3 and n_face:
            for f in faces:
                rows += _face_moments_nd(span, rv[f[0]], rv[f[1]], rv[f[2]],
                                         k - 2)
        if n_int:
            rows += _interior_moments(span, dim, int_deg)
    else:
        if dim == 2:
            for (a, b) in edges:
                rows += _edge_moments_rt2d(span, rv[a], rv[b], order - 1)
        else:
            for f in faces:
                rows += _face_moments_rt(span, rv[f[0]], rv[f[1]], rv[f[2]],
                                         order - 1)
        if n_int:
            rows += _interior_moments(span, dim, int_deg)

    V = np.stack(rows, axis=0)                       # (ndof, nspan)
    assert V.shape == (ndof, len(span)), (V.shape, ndof, len(span))
    condV = np.linalg.cond(V)
    assert condV < 1e12, f"singular Vandermonde (cond {condV:.2e})"
    C = np.linalg.inv(V)                             # span coeffs of basis

    # ---- basis (+derivative) at volume quadrature ----------------------
    pts, w = simplex_rule(dim, qdeg)
    nspan = len(span)
    vals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in span],
        axis=0,
    )                                                # (nspan, nq, dim)
    if kind == "nd":
        dcomp = [_vcurl(comps) for comps in span]
    else:
        dcomp = [_vdiv(comps) for comps in span]
    m = len(dcomp[0])
    dvals = np.stack(
        [np.stack([_peval(c, pts) for c in comps], axis=1) for comps in dcomp],
        axis=0,
    )                                                # (nspan, nq, m)
    B = np.einsum("sqd,sn->qnd", vals, C)            # (nq, ndof, dim)
    D = np.einsum("sqm,sn->qnm", dvals, C)

    # ---- orientation matrices ------------------------------------------
    # edge: generic 2D edge, reversal (shared by ND tangential & RT-2D
    # normal moments: both flip vector weight AND reverse the parameter)
    nE = n_edge
    edge_T = np.stack([np.eye(max(nE, 1))] * 2, axis=0)
    if nE:
        edge_T[1] = np.diag([-((-1.0) ** i) for i in range(nE)])
    # face: generic triangle in 2D, all 6 vertex permutations
    nF = n_face
    face_T = np.stack([np.eye(max(nF, 1))] * 6, axis=0)
    if dim == 3 and nF:
        gv = np.array([[0.1, 0.2], [1.3, 0.05], [0.4, 1.7]])
        deg = (k - 2) if kind == "nd" else (order - 1)
        mon = _monomials_upto(2, deg)
        pts2, w2 = simplex_rule(2, 2 * (deg + 5))

        def fields(vv):
            """Evaluate the moment q-fields of frame vv at the *physical*
            points of the generic triangle, as functions of the id-param."""
            # ψ: id-param pts2 → physical; σ-param coords of those points
            A = np.stack([vv[1] - vv[0], vv[2] - vv[0]], axis=1)  # (2,2)
            phys = gv[0] + pts2 @ np.stack([gv[1] - gv[0],
                                            gv[2] - gv[0]], axis=0)
            xi = np.linalg.solve(A, (phys - vv[0]).T).T          # (nq2, 2)
            out = []
            for al in mon:
                P = xi[:, 0] ** al[0] * xi[:, 1] ** al[1]
                if kind == "nd":
                    for t in (vv[1] - vv[0], vv[2] - vv[0]):
                        out.append(P[:, None] * t[None, :])      # (nq2, 2)
                else:
                    t1, t2 = vv[1] - vv[0], vv[2] - vv[0]
                    par = np.sign(t1[0] * t2[1] - t1[1] * t2[0])
                    out.append((P * par)[:, None])
            return np.stack(out, axis=0)             # (nF, nq2, c)

        ref_f = fields(gv)
        nq2 = ref_f.shape[1]
        ref_flat = (ref_f * w2[None, :, None]).reshape(nF, -1)
        ref_basis = ref_f.reshape(nF, -1)
        for si, sg in enumerate(_perm_s3()):
            sig_f = fields(gv[list(sg)])
            # F^σ_i(u) = Σ_j M[i,j] F^id_j(u) for all u ⇔ the σ-fields (as
            # L² objects on the face) expand in the id-fields
            M, *_ = np.linalg.lstsq(ref_basis.T, sig_f.reshape(nF, -1).T,
                                    rcond=None)
            face_T[si] = M.T
            resid = np.abs(ref_basis.T @ M - sig_f.reshape(nF, -1).T).max()
            assert resid < 1e-8, (si, resid)

    return dict(
        pts=pts, w=w, B=B, D=D,
        n_edge=n_edge, n_face=n_face, n_int=n_int, ndof=ndof,
        edge_T=edge_T, face_T=face_T,
        edge_Ti=np.stack([np.linalg.inv(t) for t in edge_T], axis=0),
        face_Ti=np.stack([np.linalg.inv(t) for t in face_T], axis=0),
    )


# ---------------------------------------------------------------------------
# the space: canonical entity dof numbering + per-element block transforms
# ---------------------------------------------------------------------------

import dataclasses

from ..mesh.mesh import Mesh, unique_edges, unique_faces


_S3_INDEX = {p: i for i, p in enumerate(_perm_s3())}


@dataclasses.dataclass(eq=False)
class VectorSimplexSpace:
    """ND_k / RT_q space on a tri/tet mesh with true dof transformations.

    Layout: [edge dofs | face dofs (3D) | interior dofs].  ``gather_map``
    pulls canonical dof values per local entity slot;
    ``transform``/``transform_t`` convert canonical ↔ reference-basis
    coefficients by batched per-entity block matmuls (the DofTransformation
    analog, fem/doftrans.hpp:141)."""

    mesh: Mesh
    kind: str                    # "nd" | "rt"
    order: int

    def __post_init__(self):
        mesh = self.mesh
        geom = mesh.geom
        assert geom in (Geometry.TRIANGLE, Geometry.TETRAHEDRON), geom
        dim = DIMENSION[geom]
        el = simplex_vec_element(geom, self.kind, self.order,
                                 2 * self.order + 2)
        self.element = el
        nE, nF, nI = el["n_edge"], el["n_face"], el["n_int"]
        ne = mesh.ne
        loc_edges = np.array(EDGES[geom], dtype=np.int64)
        nle = len(loc_edges)

        cols = []
        self.edge_code = None
        self.face_code = None
        ndof = 0
        if nE:
            edges, elem_edge = unique_edges(mesh)
            self.n_edges = len(edges)
            ev = mesh.elements[:, loc_edges]                 # (ne, nle, 2)
            self.edge_code = (ev[:, :, 0] > ev[:, :, 1]).astype(np.int32)
            # global ids: edge e gets [e·nE, e·nE+nE)
            g = (elem_edge[:, :, None] * nE
                 + np.arange(nE)[None, None, :])             # (ne, nle, nE)
            cols.append(g.reshape(ne, -1))
            ndof += len(edges) * nE
        if dim == 3 and nF:
            faces, elem_face = unique_faces(mesh)
            loc_faces = FACES[geom]
            fverts = mesh.elements[:, np.array(loc_faces, dtype=np.int64)]
            codes = np.zeros((ne, len(loc_faces)), dtype=np.int32)
            order_pos = np.argsort(fverts, axis=2)           # (ne, nlf, 3)
            for i, p in enumerate(_perm_s3()):
                codes[np.all(order_pos == np.array(p), axis=2)] = i
            self.face_code = codes
            off = ndof
            g = (off + elem_face[:, :, None] * nF
                 + np.arange(nF)[None, None, :])
            cols.append(g.reshape(ne, -1))
            ndof += elem_face.max() * 0 + len(faces) * nF
        if nI:
            off = ndof
            g = (off + np.arange(ne)[:, None] * nI
                 + np.arange(nI)[None, :])
            cols.append(g)
            ndof += ne * nI
        self.gather_map = np.concatenate(cols, axis=1).astype(np.int32)
        self.ndof = ndof
        self.nE, self.nF, self.nI = nE, nF, nI
        self.nle = nle
        self.nlf = len(FACES[geom]) if dim == 3 else 0
        self.dim = dim
        # jnp tables
        import jax.numpy as jnp

        from ..utils.config import real_t

        rt = real_t(None)
        self._eTi = jnp.asarray(el["edge_Ti"], rt)     # (2, nE, nE)
        self._fTi = jnp.asarray(el["face_Ti"], rt)     # (6, nF, nF)
        self._ec = jnp.asarray(self.edge_code) if nE else None
        self._fc = jnp.asarray(self.face_code) if (
            dim == 3 and nF
        ) else None

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    # -- canonical values → reference coefficients (and adjoint) ---------
    def transform(self, e):
        import jax.numpy as jnp

        ne = e.shape[0]
        out = []
        ofs = 0
        if self.nE:
            blk = e[:, : self.nle * self.nE].reshape(ne, self.nle, self.nE)
            T = self._eTi[self._ec]                   # (ne, nle, nE, nE)
            out.append(jnp.einsum("nekl,nel->nek", T, blk)
                       .reshape(ne, -1))
            ofs += self.nle * self.nE
        if self.nF and self.dim == 3:
            blk = e[:, ofs: ofs + self.nlf * self.nF].reshape(
                ne, self.nlf, self.nF)
            T = self._fTi[self._fc]
            out.append(jnp.einsum("nekl,nel->nek", T, blk)
                       .reshape(ne, -1))
            ofs += self.nlf * self.nF
        if self.nI:
            out.append(e[:, ofs:])
        return jnp.concatenate(out, axis=1)

    def transform_t(self, y):
        import jax.numpy as jnp

        ne = y.shape[0]
        out = []
        ofs = 0
        if self.nE:
            blk = y[:, : self.nle * self.nE].reshape(ne, self.nle, self.nE)
            T = self._eTi[self._ec]
            out.append(jnp.einsum("nelk,nel->nek", T, blk)
                       .reshape(ne, -1))
            ofs += self.nle * self.nE
        if self.nF and self.dim == 3:
            blk = y[:, ofs: ofs + self.nlf * self.nF].reshape(
                ne, self.nlf, self.nF)
            T = self._fTi[self._fc]
            out.append(jnp.einsum("nelk,nel->nek", T, blk)
                       .reshape(ne, -1))
            ofs += self.nlf * self.nF
        if self.nI:
            out.append(y[:, ofs:])
        return jnp.concatenate(out, axis=1)

    # -- essential (trace) dofs ------------------------------------------
    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        mesh = self.mesh
        if mesh.nbe == 0:
            return np.zeros(0, dtype=np.int32)
        if bdr_marker is None:
            sel = np.ones(mesh.nbe, dtype=bool)
        else:
            sel = np.isin(mesh.bdr_attributes,
                          np.asarray(list(bdr_marker)))
        bfac = mesh.boundary[sel]
        ess = []
        if self.dim == 2:
            # boundary "faces" are edges
            edges, _ = unique_edges(mesh)
            key = np.sort(bfac, axis=1)
            idx = _rows_in(edges, key)
            for e in idx:
                ess.extend(range(e * self.nE, (e + 1) * self.nE))
        else:
            faces, _ = unique_faces(mesh)
            fkey = np.sort(bfac, axis=1)
            fidx = _rows_in(faces, fkey)
            if self.nF:
                off = self.n_edges * self.nE if self.nE else 0
                for f in fidx:
                    ess.extend(range(off + f * self.nF,
                                     off + (f + 1) * self.nF))
            if self.nE:
                edges, _ = unique_edges(mesh)
                bedges = set()
                for f in bfac:
                    for i in range(3):
                        a, b = int(f[i]), int(f[(i + 1) % 3])
                        bedges.add((min(a, b), max(a, b)))
                ekey = np.array(sorted(bedges), dtype=np.int64)
                eidx = _rows_in(edges, ekey)
                for e in eidx:
                    ess.extend(range(e * self.nE, (e + 1) * self.nE))
        return np.array(sorted(set(ess)), dtype=np.int32)


def _rows_in(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Indices in ``table`` (lexsorted-unique rows) of each row of ``rows``."""
    if len(rows) == 0:
        return np.zeros(0, dtype=np.int64)
    d = {tuple(r): i for i, r in enumerate(table)}
    return np.array([d[tuple(r)] for r in rows], dtype=np.int64)


def NDSimplexSpace(mesh: Mesh, order: int) -> VectorSimplexSpace:
    return VectorSimplexSpace(mesh, "nd", order)


def RTSimplexSpace(mesh: Mesh, order: int) -> VectorSimplexSpace:
    return VectorSimplexSpace(mesh, "rt", order)


def _dense_transform(sp: "VectorSimplexSpace") -> np.ndarray:
    """Host-side dense (ne, ndl, ndl) canonical→reference matrices (tests,
    FULL assembly)."""
    el = sp.element
    ne = sp.mesh.ne
    ndl = sp.gather_map.shape[1]
    T = np.zeros((ne, ndl, ndl))
    ofs = 0
    if sp.nE:
        for le in range(sp.nle):
            M = el["edge_Ti"][sp.edge_code[:, le]]     # (ne, nE, nE)
            s = ofs + le * sp.nE
            T[:, s:s + sp.nE, s:s + sp.nE] = M
        ofs += sp.nle * sp.nE
    if sp.nF and sp.dim == 3:
        for lf in range(sp.nlf):
            M = el["face_Ti"][sp.face_code[:, lf]]
            s = ofs + lf * sp.nF
            T[:, s:s + sp.nF, s:s + sp.nF] = M
        ofs += sp.nlf * sp.nF
    if sp.nI:
        T[:, ofs:, ofs:] = np.eye(sp.nI)
    return T


VectorSimplexSpace.dense_transform = _dense_transform


def project_vec_simplex(sp: "VectorSimplexSpace", fn) -> np.ndarray:
    """Canonical dof values of an analytic vector field (numpy, host).

    Moment dofs commute with the covariant (ND) / Piola (RT) pullback, so
    the canonical functionals evaluate directly in physical space: edge
    moments against the physical min→max edge vector, face moments against
    the physical canonical-frame edge vectors / normal, interior moments of
    the pulled-back field (straight simplices: constant Jacobian).
    Used for exact-solution BCs and interpolation tests (the analog of
    GridFunction::ProjectCoefficient on ND/RT spaces)."""
    mesh = sp.mesh
    dim = sp.dim
    V = mesh.vertices
    out = np.zeros(sp.ndof)
    k = sp.order
    if sp.nE:
        edges, _ = unique_edges(mesh)
        xg, wg = gauss_legendre_1d(12)
        a, b = V[edges[:, 0]], V[edges[:, 1]]          # canonical min→max
        pts = a[:, None, :] + xg[None, :, None] * (b - a)[:, None, :]
        vals = np.asarray(fn(pts))                     # (nedge, nq, dim)
        if sp.kind == "nd":
            ut = np.einsum("eqd,ed->eq", vals, b - a)
        else:                                          # RT 2D: normal
            t = b - a
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
            ut = np.einsum("eqd,ed->eq", vals, n)
        for i in range(sp.nE):
            L = _legendre01(i, xg)
            out[np.arange(len(edges)) * sp.nE + i] = (
                ut * (L * wg)[None, :]
            ).sum(axis=1)
    if sp.nF and dim == 3:
        faces, _ = unique_faces(mesh)
        deg = (k - 2) if sp.kind == "nd" else (k - 1)
        pts2, w2 = simplex_rule(2, 2 * (deg + 5))
        v0, v1, v2 = V[faces[:, 0]], V[faces[:, 1]], V[faces[:, 2]]
        pts = (v0[:, None, :] + pts2[None, :, 0:1] * (v1 - v0)[:, None, :]
               + pts2[None, :, 1:2] * (v2 - v0)[:, None, :])
        vals = np.asarray(fn(pts))                     # (nface, nq, 3)
        off = (sp.n_edges * sp.nE) if sp.nE else 0
        j = 0
        for alpha in _monomials_upto(2, deg):
            P = pts2[:, 0] ** alpha[0] * pts2[:, 1] ** alpha[1]
            if sp.kind == "nd":
                for tau in (v1 - v0, v2 - v0):
                    ut = np.einsum("fqd,fd->fq", vals, tau)
                    out[off + np.arange(len(faces)) * sp.nF + j] = (
                        ut * (P * w2)[None, :]
                    ).sum(axis=1)
                    j += 1
            else:
                n = np.cross(v1 - v0, v2 - v0)
                un = np.einsum("fqd,fd->fq", vals, n)
                out[off + np.arange(len(faces)) * sp.nF + j] = (
                    un * (P * w2)[None, :]
                ).sum(axis=1)
                j += 1
    if sp.nI:
        # û = Jᵀ u (ND) or det·J⁻¹ u (RT), J constant per straight simplex
        el = sp.element
        geom = mesh.geom
        rv = REF_VERTS[geom]
        X = V[mesh.elements]                           # (ne, nv, dim)
        J = np.stack([X[:, 1 + d] - X[:, 0] for d in range(dim)], axis=2)
        if sp.kind == "nd":
            int_deg = (k - 2) if dim == 2 else (k - 3)
        else:
            int_deg = k - 2
        pts, w = simplex_rule(dim, 2 * (int_deg + 5))
        phys = np.einsum("edr,qr->eqd", J, pts) + X[:, None, 0, :]
        vals = np.asarray(fn(phys))                    # (ne, nq, dim)
        if sp.kind == "nd":
            uhat = np.einsum("edr,eqd->eqr", J, vals)
        else:
            det = np.linalg.det(J)
            Jinv = np.linalg.inv(J)
            uhat = det[:, None, None] * np.einsum(
                "erd,eqd->eqr", Jinv, vals
            )
        off = sp.ndof - mesh.ne * sp.nI
        j = 0
        for alpha in _monomials_upto(dim, int_deg):
            P = np.ones(len(pts))
            for d in range(dim):
                P = P * pts[:, d] ** alpha[d]
            for d in range(dim):
                out[off + np.arange(mesh.ne) * sp.nI + j] = (
                    uhat[:, :, d] * (P * w)[None, :]
                ).sum(axis=1)
                j += 1
    return out
