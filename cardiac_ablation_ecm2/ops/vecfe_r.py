"""Restricted-dimension H(curl)/H(div) spaces: ND_R1D, ND_R2D, RT_R2D.

Reference analog: ``ND_R1D_SegmentElement`` (fe/fe_nd.hpp:564),
``ND_R2D_SegmentElement`` / ``ND_R2D_TriangleElement`` /
``ND_R2D_QuadrilateralElement`` (fe/fe_nd.hpp:643-774), RT counterparts
(fe/fe_rt.hpp:447-609), and the ``ND_R1D_FECollection`` /
``ND_R2D_FECollection`` / ``RT_R2D_FECollection`` families
(fem/fe_coll.hpp:554-672) — exercised by ``examples/ex31.cpp`` (anisotropic
definite Maxwell, curl curl E + σE = f with full 3-component E on 1D/2D
meshes; arises in plasma physics and crystallography).

Design: no bespoke element classes.  The restricted spaces are
DIRECT SUMS of spaces the framework already has —

* ND_R2D(p)  =  ND_p(in-plane, tangential continuity)  ⊕  H1_p · ẑ
* RT_R2D(q)  =  RT_q(in-plane, normal continuity)      ⊕  L2_{q-1} · ẑ
* ND_R1D(p)  =  L2_{p-1} · x̂ (discontinuous)  ⊕  H1_p · ŷ  ⊕  H1_p · ẑ

with the 3-component basis/curl channel tables concatenated into the same
``(ne, nq, ndl, 3)`` dense batched-einsum layout ``VecFEOperator`` already
consumes — the apply inherits the batched-matmul path unchanged, and
full 3×3 matrix coefficients (the anisotropic σ of ex31) contract exactly
like the existing matrix-coefficient VectorFEMass qdata.

The de Rham structure is what fixes the component families: with ∂/∂z = 0,
curl E = (∂_y E_z, −∂_x E_z, curl₂(E_xy)), so E_z must be H1 (its in-plane
gradient appears) while curl E's z-part lands in L2; in 1D,
curl E = (0, −E_z′, E_y′) constrains only E_y, E_z.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..fem.basis import (
    gauss_legendre_1d,
    lagrange_matrices,
    h1_nodes_1d,
    make_dof_to_quad,
)
from ..fem.fespace import FESpace, L2FESpace
from ..fem.fe_vector_ho import NDSpaceHO, RTSpaceHO, _open_nodes, nd_basis_ho, \
    rt_basis_ho
from ..fem.fe_vector_simplex import (
    NDSimplexSpace,
    RTSimplexSpace,
    VectorSimplexSpace,
    _dense_transform,
    simplex_vec_element,
)
from ..fem.geometry import DIMENSION, Geometry
from ..fem.geom_factors import adjugate
from ..utils.config import index_t, real_t
from .vecfe import VecFEOperator, _geom, _mass_qd


# ---------------------------------------------------------------------------
# ND_R2D / RT_R2D: 3-component fields on 2D meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class R2DSpace:
    """Direct-sum space [in-plane vector dofs | out-of-plane scalar dofs].

    ``kind='nd'``: ND_p ⊕ H1_p ẑ (tangential continuity: the boundary-edge
    tangent plane contains both the in-plane tangent and ẑ, so essential
    E×n=0 pins BOTH blocks' boundary dofs).
    ``kind='rt'``: RT_q ⊕ L2_{q-1} ẑ (normal continuity: only the in-plane
    block has a normal trace; the ẑ block is discontinuous)."""

    mesh: object
    order: int
    kind: str
    vec: object = None     # in-plane ND/RT space
    sca: object = None     # out-of-plane H1 (nd) / L2 (rt) space

    def __post_init__(self):
        mesh, p = self.mesh, self.order
        if self.vec is None:
            if self.kind == "nd":
                self.vec = (NDSimplexSpace(mesh, p)
                            if mesh.geom == Geometry.TRIANGLE
                            else NDSpaceHO(mesh, p))
                self.sca = FESpace(mesh, p)
            else:
                self.vec = (RTSimplexSpace(mesh, p)
                            if mesh.geom == Geometry.TRIANGLE
                            else RTSpaceHO(mesh, p))
                self.sca = L2FESpace(mesh, p - 1)
        gv = np.asarray(self.vec.gather_map, np.int64)
        gs = np.asarray(self.sca.gather_map, np.int64) + self.vec.ndof
        self.gather_map = np.concatenate([gv, gs], axis=1).astype(np.int32)
        self.nvec = gv.shape[1]

    @property
    def ndof(self):
        return self.vec.ndof + self.sca.ndof

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    # DofTransformation pass-through (simplex in-plane block only; the
    # scalar block needs none)
    @property
    def has_tf(self):
        return isinstance(self.vec, VectorSimplexSpace)

    def transform(self, e):
        n = self.nvec
        return jnp.concatenate(
            [self.vec.transform(e[:, :n]), e[:, n:]], axis=1)

    def transform_t(self, y):
        n = self.nvec
        return jnp.concatenate(
            [self.vec.transform_t(y[:, :n]), y[:, n:]], axis=1)

    def dense_transform(self):
        T = _dense_transform(self.vec)                 # (ne, nvec, nvec)
        ne, n, _ = T.shape
        m = self.nd_elem
        out = np.tile(np.eye(m), (ne, 1, 1))
        out[:, :n, :n] = T
        return out

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        ess = [np.asarray(self.vec.essential_dofs(bdr_marker), np.int64)]
        if self.kind == "nd":
            ess.append(
                np.asarray(self.sca.essential_dofs(bdr_marker), np.int64)
                + self.vec.ndof)
        return np.unique(np.concatenate(ess)).astype(np.int32)


def NDR2DSpace(mesh, order: int) -> R2DSpace:
    """ND_R2D_FECollection analog (fem/fe_coll.hpp:618)."""
    return R2DSpace(mesh, order, "nd")


def RTR2DSpace(mesh, order: int) -> R2DSpace:
    """RT_R2D_FECollection analog (fem/fe_coll.hpp:662)."""
    return R2DSpace(mesh, order, "rt")


def _scalar_tables(mesh, order, nq1d, pts_expect):
    """Full (nq, nd) basis + (nq, nd, 2) gradient tables of the scalar block
    at the SAME quadrature rule the vector tables use (asserted).  Uses the
    default node family — the same ``make_dof_to_quad`` call FESpace /
    L2FESpace pair their gather maps with."""
    d2q = make_dof_to_quad(mesh.geom, order, nq1d)
    assert np.allclose(d2q.points, pts_expect), \
        "scalar/vector quadrature rules diverged"
    return d2q.full_B(), d2q.full_G()


def _vec_tables(space, nq1d):
    """Reference in-plane basis/curl-or-div tables (matches build_nd/rt)."""
    mesh = space.mesh
    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(mesh.geom, space.kind, space.order,
                                 2 * nq1d - 1)
        return el["pts"], el["B"], el["D"]
    if space.kind == "nd":
        return nd_basis_ho(mesh.geom, space.order, nq1d)
    pts, B, D = rt_basis_ho(mesh.geom, space.order - 1, nq1d)
    return pts, B, D[..., None]


def build_nd_r2d_operator(
    space: R2DSpace,
    mass_coeff: Optional[float] = 1.0,
    curlcurl_coeff: Optional[float] = None,
    nq1d: Optional[int] = None,
    dtype=None,
) -> VecFEOperator:
    """(σ E, F) + (ν curl E, curl F) with 3-component E, F on a 2D mesh.

    ``mass_coeff`` / ``curlcurl_coeff``: scalar, callable, or full 3×3
    matrix (callable returning (ne, nq, 3, 3) included) — the ex31
    anisotropic-σ configuration (bilininteg VectorFEMass/CurlCurl with
    MatrixCoefficient)."""
    mesh = space.mesh
    p = space.order
    if nq1d is None:
        nq1d = p + 2
    rt = real_t(dtype)
    gf = _geom(mesh, nq1d, dtype)
    J, det = gf.jac, gf.det
    A = adjugate(J)
    Jinv = A / det[..., None, None]

    pts, Bref, Cref = _vec_tables(space.vec, nq1d)
    Bh, Gh = _scalar_tables(mesh, p, nq1d, pts)
    ne, nq = det.shape
    nv, nh = Bref.shape[1], Bh.shape[1]

    # physical in-plane ND basis (covariant): rows 0,1; z channel = 0
    Bnd = jnp.einsum("eqab,qna->eqnb", Jinv, jnp.asarray(Bref, rt))
    # physical H1 value: z channel only
    Bq = jnp.zeros((ne, nq, nv + nh, 3), rt)
    Bq = Bq.at[:, :, :nv, :2].set(Bnd)
    Bq = Bq.at[:, :, nv:, 2].set(jnp.asarray(Bh, rt)[None])

    terms = []
    if mass_coeff is not None:
        terms.append(("mass", _mass_qd(gf, mass_coeff, rt), Bq))
    if curlcurl_coeff is not None:
        # curl E = (∂_y E_z, −∂_x E_z, curl₂ E_xy):
        #   ND block → z channel, scalar 2D curl pullback c/det
        #   H1 block → in-plane (g_y, −g_x) with g = J^{-T}∇̂ψ the physical
        #   gradient
        Cnd = jnp.asarray(Cref[..., 0], rt)[None] / det[..., None]
        Gphys = jnp.einsum("eqab,qna->eqnb", Jinv, jnp.asarray(Gh, rt))
        Cq = jnp.zeros((ne, nq, nv + nh, 3), rt)
        Cq = Cq.at[:, :, :nv, 2].set(jnp.broadcast_to(Cnd, (ne, nq, nv)))
        Cq = Cq.at[:, :, nv:, 0].set(Gphys[..., 1])
        Cq = Cq.at[:, :, nv:, 1].set(-Gphys[..., 0])
        terms.append(("curlcurl", _mass_qd(gf, curlcurl_coeff, rt), Cq))
    return _r_op(space, terms, gf, rt)


def build_rt_r2d_operator(
    space: R2DSpace,
    mass_coeff: Optional[float] = 1.0,
    divdiv_coeff: Optional[float] = None,
    nq1d: Optional[int] = None,
    dtype=None,
) -> VecFEOperator:
    """(α u, v) + (β div u, div v) with 3-component u on a 2D mesh.

    div u = in-plane divergence (∂/∂z ≡ 0); the ẑ block is div-free."""
    mesh = space.mesh
    q = space.order
    if nq1d is None:
        nq1d = q + 2
    rt = real_t(dtype)
    gf = _geom(mesh, nq1d, dtype)
    J, det = gf.jac, gf.det

    pts, Bref, Dref = _vec_tables(space.vec, nq1d)
    Bh, _ = _scalar_tables(mesh, q - 1, nq1d, pts)
    ne, nq = det.shape
    nv, nh = Bref.shape[1], Bh.shape[1]

    # contravariant (Piola) in-plane pullback; z channel = plain value
    Brt = jnp.einsum("eqab,qnb->eqna", J / det[..., None, None],
                     jnp.asarray(Bref, rt))
    Bq = jnp.zeros((ne, nq, nv + nh, 3), rt)
    Bq = Bq.at[:, :, :nv, :2].set(Brt)
    Bq = Bq.at[:, :, nv:, 2].set(jnp.asarray(Bh, rt)[None])

    terms = []
    if mass_coeff is not None:
        terms.append(("mass", _mass_qd(gf, mass_coeff, rt), Bq))
    if divdiv_coeff is not None:
        Drt = jnp.asarray(Dref[..., 0], rt)[None] / det[..., None]
        Dq = jnp.zeros((ne, nq, nv + nh, 1), rt)
        Dq = Dq.at[:, :, :nv, 0].set(jnp.broadcast_to(Drt, (ne, nq, nv)))
        if callable(divdiv_coeff):
            qd = jnp.asarray(divdiv_coeff(gf.x), rt) * gf.wdet
        else:
            qd = float(divdiv_coeff) * gf.wdet
        terms.append(("divdiv", qd, Dq))
    return _r_op(space, terms, gf, rt)


def _r_op(space, terms, gf, rt):
    gather = jnp.asarray(space.gather_map, index_t())
    if space.has_tf:
        return VecFEOperator(
            space=space, gather=gather,
            signs=jnp.ones(gather.shape, rt), terms=tuple(terms),
            ndof=space.ndof, gf=gf,
            tf=space.transform, tft=space.transform_t)
    sv = np.asarray(space.vec.signs)
    signs = np.concatenate(
        [sv, np.ones((sv.shape[0], space.nd_elem - space.nvec))], axis=1)
    return VecFEOperator(
        space=space, gather=gather, signs=jnp.asarray(signs, rt),
        terms=tuple(terms), ndof=space.ndof, gf=gf)


# ---------------------------------------------------------------------------
# ND_R1D: 3-component fields on 1D segment meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class NDR1DSpace:
    """ND_R1D_FECollection analog (fem/fe_coll.hpp:554) on the segment mesh
    with breakpoints ``x`` (sorted, (nv,)).

    Per-element dof layout: [E_x: p open (discontinuous)] then
    [E_y: p+1 closed] [E_z: p+1 closed] in 1D node order; E_y/E_z vertex
    dofs are shared between neighbors (H1 continuity — they are the
    tangential components at a 1D interface)."""

    x: np.ndarray
    order: int

    def __post_init__(self):
        self.x = np.asarray(self.x, np.float64)
        assert self.x.ndim == 1 and len(self.x) >= 2
        p = self.order
        nv = len(self.x)
        ne = nv - 1
        nx = ne * p                       # E_x block (L2)
        nyz = nv + ne * (p - 1)           # one H1 component
        self.ndof = nx + 2 * nyz
        g = np.zeros((ne, 3 * p + 2), dtype=np.int32)
        for e in range(ne):
            g[e, :p] = e * p + np.arange(p)
            for c in range(2):            # E_y then E_z
                off = nx + c * nyz
                col = p + c * (p + 1)
                g[e, col] = off + e
                g[e, col + p] = off + e + 1
                g[e, col + 1: col + p] = off + nv + e * (p - 1) + \
                    np.arange(p - 1)
        self.gather_map = g
        self._nyz_off = nx

    @property
    def ne(self):
        return len(self.x) - 1

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        # tangential components at the endpoints are E_y, E_z
        nv = len(self.x)
        nyz = nv + self.ne * (self.order - 1)
        o = self._nyz_off
        return np.array([o, o + nv - 1, o + nyz, o + nyz + nv - 1],
                        dtype=np.int32)


class _GF1D:
    """Minimal geometric-factor carrier for the linear-form path."""

    def __init__(self, x, wdet):
        self.x = x          # (ne, nq, 1)
        self.wdet = wdet    # (ne, nq)


def build_nd_r1d_operator(
    space: NDR1DSpace,
    mass_coeff: Optional[float] = 1.0,
    curlcurl_coeff: Optional[float] = None,
    nq1d: Optional[int] = None,
    dtype=None,
) -> VecFEOperator:
    """(σ E, F) + (ν curl E, curl F) on a 1D mesh with 3-component E.

    curl E = (0, −E_z′, E_y′): E_x rides along in the mass term only (it is
    in the kernel of curl — the 1D analog of gradients ⊂ ND)."""
    p = space.order
    if nq1d is None:
        nq1d = p + 2
    rt = real_t(dtype)
    xq, wq = gauss_legendre_1d(nq1d)
    Bo, _ = lagrange_matrices(_open_nodes(p), xq)          # (nq, p)
    Bc, Gc = lagrange_matrices(h1_nodes_1d(p), xq)         # (nq, p+1)

    h = np.diff(space.x)                                   # (ne,)
    ne, nq = len(h), len(xq)
    xphys = (space.x[:-1, None] + h[:, None] * xq[None, :])[..., None]
    wdet = jnp.asarray(wq[None, :] * h[:, None], rt)
    gf = _GF1D(jnp.asarray(xphys, rt), wdet)

    ndl = space.nd_elem
    Bq = np.zeros((ne, nq, ndl, 3))
    Bq[:, :, :p, 0] = Bo[None]
    Bq[:, :, p:2 * p + 1, 1] = Bc[None]
    Bq[:, :, 2 * p + 1:, 2] = Bc[None]
    terms = []
    if mass_coeff is not None:
        terms.append(("mass", _mass_qd(gf, mass_coeff, rt),
                      jnp.asarray(Bq, rt)))
    if curlcurl_coeff is not None:
        Cq = np.zeros((ne, nq, ndl, 3))
        Gphys = Gc[None] / h[:, None, None]                # (ne, nq, p+1)
        Cq[:, :, p:2 * p + 1, 2] = Gphys                   # +E_y′ ẑ
        Cq[:, :, 2 * p + 1:, 1] = -Gphys                   # −E_z′ ŷ
        terms.append(("curlcurl", _mass_qd(gf, curlcurl_coeff, rt),
                      jnp.asarray(Cq, rt)))
    return VecFEOperator(
        space=space,
        gather=jnp.asarray(space.gather_map, index_t()),
        signs=jnp.ones(space.gather_map.shape, rt),
        terms=tuple(terms), ndof=space.ndof, gf=gf)
