"""Nodal finite-element bases.

Reference analog: ``fem/fe/`` (31.5k LoC of per-geometry basis classes) and
``DofToQuad`` — the B/G basis-evaluation matrices with TENSOR (1D factors) and
FULL modes (``fem/fe/fe_base.hpp:140,153-170``).  TENSOR mode is the
sum-factorization path (batched einsums); FULL mode is the dense per-element
path used for simplices (batched matmul).

Design: a basis is *data*, not a class hierarchy — a lattice of
nodal points plus dense evaluation matrices, computed host-side in float64.

* Tensor geometries (segment/quad/hex): H1 nodes are Gauss-Lobatto points per
  direction (matching ``H1_FECollection``'s default GaussLobatto nodal basis,
  ``fem/fe_coll.hpp:278``); only the 1D matrices ``B1 (nq1d, p+1)`` and
  ``G1`` are stored.
* Simplices (tri/tet): equispaced lattice nodes, full ``B (nq, nd)`` /
  ``G (nq, nd, dim)`` matrices from a monomial Vandermonde solve (orders ≤ 6).

Local dof ordering is **lexicographic** everywhere (the reference's
``ElementDofOrdering::LEXICOGRAPHIC``, ``fem/fespace.hpp:47``): for tensor
elements dof = i + n1d*(j + n1d*k); for simplices lattice points sorted by
(k, j, i) with i fastest, i+j+k ≤ p.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from .geometry import Geometry, IS_TENSOR, DIMENSION, REF_VERTS
from .intrules import gauss_legendre_1d, gauss_lobatto_1d, simplex_rule, tensor_rule


# ----------------------------------------------------------------------------
# 1D Lagrange machinery
# ----------------------------------------------------------------------------


def lagrange_matrices(nodes: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate the Lagrange basis through ``nodes`` at points ``x``.

    Returns ``(B, G)`` with ``B[q, i] = L_i(x_q)`` and ``G[q, i] = L_i'(x_q)``.
    Uses a monomial Vandermonde solve — exact at nodes, well-conditioned for
    the n ≤ ~9 node counts (order ≤ 8) this library targets.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)  # V[i, j] = nodes_i^j
    C = np.linalg.solve(V, np.eye(n))  # C[:, i] = coeffs of L_i
    P = np.vander(x, n, increasing=True)
    dP = np.zeros_like(P)
    dP[:, 1:] = P[:, :-1] * np.arange(1, n)
    return P @ C, dP @ C


@functools.lru_cache(maxsize=None)
def h1_nodes_1d(p: int) -> np.ndarray:
    """H1 nodal points on [0,1] for order p: Gauss-Lobatto (p+1 points)."""
    x, _ = gauss_lobatto_1d(p + 1)
    return x


@functools.lru_cache(maxsize=None)
def l2_nodes_1d(p: int) -> np.ndarray:
    """L2 (discontinuous) nodal points on [0,1]: Gauss-Legendre (p+1 points)."""
    x, _ = gauss_legendre_1d(p + 1)
    return x


# ----------------------------------------------------------------------------
# Lattices and multi-indices
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def lattice_multi_index(geom: Geometry, p: int) -> np.ndarray:
    """Integer lattice multi-indices of the local nodal points, lex-ordered.

    Tensor geometries: all (i[,j[,k]]) in [0,p]^dim, i fastest.
    Simplices: (i[,j[,k]]) with sum ≤ p, i fastest.
    Shape (nd, dim), int64.
    """
    dim = DIMENSION[geom]
    if IS_TENSOR.get(geom, False) or geom == Geometry.SEGMENT:
        rng = np.arange(p + 1)
        grids = np.meshgrid(*([rng] * dim), indexing="ij")
        idx = np.stack([g.ravel(order="F") for g in grids], axis=1)
        return idx
    if geom == Geometry.TRIANGLE:
        out = [(i, j) for j in range(p + 1) for i in range(p + 1 - j)]
        return np.array(out, dtype=np.int64)
    if geom == Geometry.TETRAHEDRON:
        out = [
            (i, j, k)
            for k in range(p + 1)
            for j in range(p + 1 - k)
            for i in range(p + 1 - j - k)
        ]
        return np.array(out, dtype=np.int64)
    if geom == Geometry.PRISM:
        # triangle lattice × segment (wedge, fem/fe/fe_h1.cpp H1_WedgeElement)
        out = [
            (i, j, k)
            for k in range(p + 1)
            for j in range(p + 1)
            for i in range(p + 1 - j)
        ]
        return np.array(out, dtype=np.int64)
    if geom == Geometry.PYRAMID:
        # pyramids have no polynomial lattice (rational basis): order ≥ 2
        # node layouts live in fem/pyramid2.py / pyramid3.py / pyramid_p.py
        if p != 1:
            raise NotImplementedError(
                "pyramid node layout is not a lattice at p >= 2; "
                "see fem/pyramid_p.py")
        return np.rint(REF_VERTS[geom]).astype(np.int64)
    raise ValueError(f"unsupported geometry {geom}")


@functools.lru_cache(maxsize=None)
def h1_nodes(geom: Geometry, p: int) -> np.ndarray:
    """Reference coordinates of the local H1 nodal points, lex-ordered (nd, dim)."""
    if geom == Geometry.PYRAMID and p >= 2:
        # rational pyramid: nodes are entity tables, not a lattice
        if p == 2:
            from .pyramid2 import PYRAMID_P2_NODES

            return PYRAMID_P2_NODES
        if p == 3:
            from .pyramid3 import PYRAMID_P3_NODES

            return PYRAMID_P3_NODES
        from .pyramid_p import pyramid_nodes

        return pyramid_nodes(p)
    mi = lattice_multi_index(geom, p)
    if IS_TENSOR.get(geom, False) or geom == Geometry.SEGMENT:
        x1 = h1_nodes_1d(p)
        return x1[mi]
    if geom == Geometry.PRISM:
        # triangle part = the (edge-warped) triangle nodes, vertical GLL
        tri_mi = lattice_multi_index(Geometry.TRIANGLE, p)
        tri_pts = h1_nodes(Geometry.TRIANGLE, p)
        tmap = {tuple(r): i for i, r in enumerate(tri_mi)}
        xy = np.stack([tri_pts[tmap[(i, j)]] for (i, j, _k) in mi])
        z = h1_nodes_1d(p)[mi[:, 2]]
        return np.concatenate([xy, z[:, None]], axis=1)
    if geom == Geometry.PYRAMID:
        return mi.astype(np.float64)
    # simplices: equispaced lattice with EDGE nodes warped to the 1D GLL
    # positions — the edge trace then matches the tensor (quad/hex) elements'
    # GLL traces, which is what makes mixed tri+quad meshes H1-conforming
    # (same rule as the reference's H1 simplex collections, fe_h1.cpp).
    pts = mi.astype(np.float64) / max(p, 1)
    if p >= 2:
        from .geometry import EDGES, REF_VERTS

        rv = REF_VERTS[geom]
        latt_v = np.rint(rv * p).astype(np.int64)
        gll = h1_nodes_1d(p)
        for (la, lb) in EDGES[geom]:
            A, B = latt_v[la], latt_v[lb]
            for t in range(1, p):
                latt = tuple((A * (p - t) + B * t) // p)
                n = np.nonzero((mi == np.array(latt)).all(axis=1))[0]
                if len(n):
                    pts[n[0]] = rv[la] + gll[t] * (rv[lb] - rv[la])
    return pts


# ----------------------------------------------------------------------------
# DofToQuad
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: id-hash (cached objects)
class DofToQuad:
    """Basis evaluation data at a quadrature rule (fem/fe/fe_base.hpp:140).

    ``tensor=True``  → ``B1 (nq1d, n1d)``, ``G1 (nq1d, n1d)`` 1D factors; the
    full maps are Kronecker products realized as einsum contractions.
    ``tensor=False`` → ``B (nq, nd)``, ``G (nq, nd, dim)`` dense.
    Quadrature points/weights for the rule are included (numpy, float64).
    """

    geom: Geometry
    order: int
    tensor: bool
    points: np.ndarray   # (nq, dim)
    weights: np.ndarray  # (nq,)
    B1: Optional[np.ndarray] = None
    G1: Optional[np.ndarray] = None
    B: Optional[np.ndarray] = None
    G: Optional[np.ndarray] = None

    @property
    def dim(self) -> int:
        return DIMENSION[self.geom]

    @property
    def nq1d(self) -> int:
        return 0 if self.B1 is None else self.B1.shape[0]

    @property
    def n1d(self) -> int:
        return 0 if self.B1 is None else self.B1.shape[1]

    @property
    def ndof(self) -> int:
        if self.tensor:
            return self.n1d ** self.dim
        return self.B.shape[1]

    @property
    def nq(self) -> int:
        return len(self.weights)

    def full_B(self) -> np.ndarray:
        """Densify to (nq, nd) — used by tests and the FULL-mode fallback."""
        if not self.tensor:
            return self.B
        return _lex_kron(self.B1, self.dim, deriv_axis=None)

    def full_G(self) -> np.ndarray:
        """Densify gradients to (nq, nd, dim)."""
        if not self.tensor:
            return self.G
        cols = [
            _lex_kron(self.B1, self.dim, deriv_axis=d, G1=self.G1)
            for d in range(self.dim)
        ]
        return np.stack(cols, axis=-1)


def _lex_kron(B1: np.ndarray, dim: int, deriv_axis, G1=None) -> np.ndarray:
    """Kronecker product of 1D factors under lexicographic (i-fastest) ordering.

    Entry [(qx,qy,qz), (i,j,k)] = Fx[qx,i] Fy[qy,j] Fz[qz,k] where the factor
    along ``deriv_axis`` is G1 instead of B1.
    """
    nq1, n1 = B1.shape
    fac = [G1 if d == deriv_axis else B1 for d in range(dim)]
    if dim == 1:
        return fac[0]
    if dim == 2:
        # A[qy,qx,iy,ix]; C-order flatten gives row qx + nq1*qy, col ix + n1*iy
        M = np.einsum("ai,bj->abij", fac[1], fac[0])
        return M.reshape(nq1 * nq1, n1 * n1)
    if dim == 3:
        M = np.einsum("ai,bj,ck->abcijk", fac[2], fac[1], fac[0])
        return M.reshape(nq1**3, n1**3)
    raise ValueError(dim)


@functools.lru_cache(maxsize=None)
def make_dof_to_quad(
    geom: Geometry, p: int, nq1d: Optional[int] = None, nodes: str = "h1"
) -> DofToQuad:
    """Build the DofToQuad data for H1/L2 order-p basis on ``geom``.

    ``nq1d`` — 1D quadrature points for tensor geometries (default p+2);
    for simplices it is interpreted as exactness order ≈ 2*nq1d-1.
    """
    dim = DIMENSION[geom]
    if nq1d is None:
        nq1d = p + 2
    nodes_1d = h1_nodes_1d(p) if nodes == "h1" else l2_nodes_1d(p)
    if IS_TENSOR.get(geom, False) or geom == Geometry.SEGMENT:
        xq, _ = gauss_legendre_1d(nq1d)
        B1, G1 = lagrange_matrices(nodes_1d, xq)
        pts, wts = tensor_rule(dim, nq1d)
        return DofToQuad(
            geom=geom, order=p, tensor=True, points=pts, weights=wts, B1=B1, G1=G1
        )
    if geom == Geometry.PRISM:
        pts, wts = prism_rule(nq1d)
        B, G = prism_basis_matrices(p, pts, nodes_1d)
        return DofToQuad(
            geom=geom, order=p, tensor=False, points=pts, weights=wts, B=B, G=G
        )
    if geom == Geometry.PYRAMID:
        pts, wts = pyramid_rule(nq1d)
        if p == 2:
            from .pyramid2 import pyramid_p2_basis_matrices

            B, G = pyramid_p2_basis_matrices(pts)
        elif p == 3:
            from .pyramid3 import pyramid_p3_basis_matrices

            B, G = pyramid_p3_basis_matrices(pts)
        elif p >= 4:
            from .pyramid_p import pyramid_p_basis_matrices

            B, G = pyramid_p_basis_matrices(p, pts)
        else:
            B, G = pyramid_basis_matrices(p, pts)
        return DofToQuad(
            geom=geom, order=p, tensor=False, points=pts, weights=wts, B=B, G=G
        )
    # simplex dense path
    qorder = 2 * nq1d - 1
    pts, wts = simplex_rule(dim, qorder)
    B, G = simplex_basis_matrices(geom, p, pts)
    return DofToQuad(
        geom=geom, order=p, tensor=False, points=pts, weights=wts, B=B, G=G
    )


def simplex_basis_matrices(
    geom: Geometry, p: int, pts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense nodal basis matrices for tri/tet via monomial Vandermonde solve.

    Returns B (npts, nd), G (npts, nd, dim).
    """
    dim = DIMENSION[geom]
    mi = lattice_multi_index(geom, p)  # polynomial powers = lattice multi-indices
    nodes = h1_nodes(geom, p)

    def vand(x):
        # V[a, b] = prod_d x[a,d]^mi[b,d]
        V = np.ones((len(x), len(mi)))
        for d in range(dim):
            V *= x[:, d][:, None] ** mi[:, d][None, :]
        return V

    Vn = vand(nodes)
    C = np.linalg.solve(Vn, np.eye(len(mi)))  # coeffs per basis function
    B = vand(pts) @ C
    G = np.zeros((len(pts), len(mi), dim))
    for d in range(dim):
        dmi = mi.copy()
        pw = dmi[:, d].copy()
        dmi[:, d] = np.maximum(pw - 1, 0)
        dV = np.ones((len(pts), len(mi)))
        for e in range(dim):
            dV *= pts[:, e][:, None] ** dmi[:, e][None, :]
        dV *= pw[None, :]
        G[:, :, d] = dV @ C
    return B, G


@functools.lru_cache(maxsize=None)
def prism_rule(nq1d: int):
    """Wedge quadrature: triangle conical rule × 1D Gauss (nq2·nq1d points)."""
    from .intrules import gauss_legendre_1d, simplex_rule

    p2, w2 = simplex_rule(2, 2 * nq1d - 1)
    z, wz = gauss_legendre_1d(nq1d)
    nq2, nq1 = len(p2), len(z)
    pts = np.zeros((nq2 * nq1, 3))
    wts = np.zeros(nq2 * nq1)
    for k in range(nq1):
        pts[k * nq2:(k + 1) * nq2, :2] = p2
        pts[k * nq2:(k + 1) * nq2, 2] = z[k]
        wts[k * nq2:(k + 1) * nq2] = w2 * wz[k]
    return pts, wts


def prism_basis_matrices(p: int, pts: np.ndarray, nodes_1d: np.ndarray):
    """Dense wedge nodal basis (triangle simplex ⊗ 1D Lagrange).

    Reference analog: ``H1_WedgeElement`` (fem/fe/fe_h1.cpp) — tensor of
    ``H1_TriangleElement`` and ``H1_SegmentElement``.
    Returns B (npts, nd), G (npts, nd, 3)."""
    from .geometry import Geometry as _G

    Bt, Gt = simplex_basis_matrices(_G.TRIANGLE, p, pts[:, :2])
    Bz, Gz = lagrange_matrices(nodes_1d, pts[:, 2])
    mi = lattice_multi_index(_G.PRISM, p)
    mi_t = lattice_multi_index(_G.TRIANGLE, p)
    tmap = {tuple(r): i for i, r in enumerate(mi_t)}
    nd = len(mi)
    B = np.zeros((len(pts), nd))
    G = np.zeros((len(pts), nd, 3))
    for n, (i, j, k) in enumerate(mi):
        t = tmap[(i, j)]
        B[:, n] = Bt[:, t] * Bz[:, k]
        G[:, n, 0] = Gt[:, t, 0] * Bz[:, k]
        G[:, n, 1] = Gt[:, t, 1] * Bz[:, k]
        G[:, n, 2] = Bt[:, t] * Gz[:, k]
    return B, G


@functools.lru_cache(maxsize=None)
def pyramid_rule(nq1d: int):
    """Pyramid quadrature: cube Gauss rule mapped (x,y,z) → ((1−z)x, (1−z)y, z)
    with Jacobian (1−z)² (conical product — all points interior, so the
    rational basis is regular at every point)."""
    from .intrules import tensor_rule

    pc, wc = tensor_rule(3, nq1d)
    z = pc[:, 2]
    pts = np.stack([(1 - z) * pc[:, 0], (1 - z) * pc[:, 1], z], axis=1)
    return pts, wc * (1 - z) ** 2


def pyramid_basis_matrices(p: int, pts: np.ndarray):
    """Rational vertex basis of the linear pyramid
    (fem/fe/fe_fixed_order.cpp LinearPyramidFiniteElement):
    with s = 1 − z:  N0=(s−x)(s−y)/s, N1=x(s−y)/s, N2=xy/s, N3=(s−x)y/s,
    N4=z.  Exact for linears; Σ N = 1."""
    assert p == 1
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    s = 1.0 - z
    B = np.stack([
        (s - x) * (s - y) / s, x * (s - y) / s, x * y / s, (s - x) * y / s, z,
    ], axis=1)
    G = np.zeros((len(pts), 5, 3))
    # exact expansions: N0 = s − x − y + xy/s; N1 = x − xy/s; N2 = xy/s;
    # N3 = y − xy/s; N4 = z;  with ds/dz = −1 ⇒ d(xy/s)/dz = xy/s².
    G[:, 0, 0] = -1.0 + y / s
    G[:, 0, 1] = -1.0 + x / s
    G[:, 0, 2] = -1.0 + x * y / s**2
    G[:, 1, 0] = 1.0 - y / s
    G[:, 1, 1] = -x / s
    G[:, 1, 2] = -x * y / s**2
    G[:, 2, 0] = y / s
    G[:, 2, 1] = x / s
    G[:, 2, 2] = x * y / s**2
    G[:, 3, 0] = -y / s
    G[:, 3, 1] = 1.0 - x / s
    G[:, 3, 2] = -x * y / s**2
    G[:, 4, 2] = 1.0
    return B, G


def bernstein_matrices(p: int, x: np.ndarray):
    """Bernstein (positive) 1D basis B_i(x) = C(p,i) xⁱ(1−x)^(p−i) and its
    derivative, evaluated at ``x`` → (B (nx, p+1), G (nx, p+1)).

    Reference analog: the H1Pos/L2Pos collections (``fem/fe/fe_pos.cpp``) —
    a positive partition of unity on the same entity-lattice dof layout as
    the nodal basis (edge traces depend only on edge-layer coefficients, so
    conformity wiring is unchanged); used for bound-preserving limiting and
    visualization.
    """
    from math import comb

    x = np.asarray(x, dtype=np.float64)
    B = np.zeros((len(x), p + 1))
    G = np.zeros((len(x), p + 1))
    for i in range(p + 1):
        c = comb(p, i)
        B[:, i] = c * x**i * (1 - x) ** (p - i)
        # d/dx [x^i (1-x)^(p-i)]
        t1 = i * x ** max(i - 1, 0) * (1 - x) ** (p - i) if i > 0 else 0.0
        t2 = ((p - i) * x**i * (1 - x) ** max(p - i - 1, 0)
              if i < p else 0.0)
        G[:, i] = c * (t1 - t2)
    return B, G


def nodal_to_bernstein(p: int) -> np.ndarray:
    """Change-of-basis N (p+1, p+1): Bernstein coefficients = N @ nodal
    values at the GLL points (exact, both bases span P_p)."""
    x = h1_nodes_1d(p)
    Bb, _ = bernstein_matrices(p, x)        # Bernstein evaluated at GLL nodes
    # nodal values v = Bb @ c  ⇒  c = Bb⁻¹ v
    return np.linalg.inv(Bb)
