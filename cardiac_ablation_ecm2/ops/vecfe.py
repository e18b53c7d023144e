"""H(curl)/H(div) operators: VectorFEMass, CurlCurl, DivDiv (lowest order).

Reference analog: ``VectorFEMassIntegrator`` (``fem/bilininteg.hpp``),
``CurlCurlIntegrator`` (``:2808``), ``DivDivIntegrator``, with PA kernels in
``fem/integ/bilininteg_vectorfe*.cpp`` / ``bilininteg_curlcurl_pa.cpp``.

Pullbacks on an element with Jacobian J (ne, nq, dim, dim):
* H(curl): E = J^{-T} Ê;    curl E = J (∇̂×Ê)/detJ (3D), (∇̂×Ê)/detJ (2D)
* H(div):  u = J û / detJ;  div u = (∇̂·û)/detJ

Element dof counts are tiny (≤12) so applies are dense batched einsums —
large batched matmuls once batched over elements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..fem.fe_vector import NDSpace, RTSpace, nd0_basis, rt0_basis
from ..fem.fe_vector_ho import nd_basis_ho, rt_basis_ho
from ..fem.fespace import element_node_coords
from ..fem.basis import make_dof_to_quad
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..utils.config import index_t, real_t


@dataclasses.dataclass(eq=False)
class VecFEOperator:
    """Matrix-free Σ terms of mass/curlcurl (ND) or mass/divdiv (RT).

    Orientation handling: either a per-dof ``signs`` multiply (tensor
    elements, lowest-order simplices) or the true DofTransformation pair
    ``tf``/``tft`` (canonical → reference-coefficient block matmuls,
    fem/doftrans.hpp:141) from a ``VectorSimplexSpace``."""

    space: object                 # NDSpace / RTSpace / VectorSimplexSpace
    gather: jnp.ndarray           # (ne, ndl)
    signs: jnp.ndarray            # (ne, ndl)
    terms: tuple                  # of (name, qdata, Bq) — see below
    ndof: int
    gf: object = None             # GeometricFactors (for linear forms)
    tf: object = None             # canonical values → reference coeffs
    tft: object = None            # adjoint

    def _pre(self, e):
        return self.tf(e) if self.tf is not None else e * self.signs

    def _post(self, y):
        return self.tft(y) if self.tft is not None else y * self.signs

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        e = self._pre(x[self.gather])
        y = None
        for name, qd, Bq in self.terms:
            # Bq: (ne, nq, ndl, c); qd: (ne, nq[, c, c'])
            v = jnp.einsum("eqnc,en->eqc", Bq, e)
            if qd.ndim == 4:
                v = jnp.einsum("eqcd,eqd->eqc", qd, v)
            else:
                v = v * qd[..., None]
            t = jnp.einsum("eqnc,eqc->en", Bq, v)
            y = t if y is None else y + t
        y = self._post(y)
        out = jnp.zeros(self.ndof, dtype=x.dtype)
        return out.at[self.gather.reshape(-1)].add(y.reshape(-1))

    def _elem_mats(self, xp=jnp):
        A_e = None
        for name, qd, Bq in self.terms:
            if xp is np:
                qd, Bq = np.asarray(qd), np.asarray(Bq)
            if qd.ndim == 4:
                t = xp.einsum("eqmc,eqcd,eqnd->emn", Bq, qd, Bq)
            else:
                t = xp.einsum("eqmc,eq,eqnc->emn", Bq, qd, Bq)
            A_e = t if A_e is None else A_e + t
        return A_e

    def diagonal(self) -> jnp.ndarray:
        if self.tf is None:
            d = None
            for name, qd, Bq in self.terms:
                if qd.ndim == 4:
                    t = jnp.einsum("eqnc,eqcd,eqnd->en", Bq, qd, Bq)
                else:
                    t = jnp.einsum("eqnc,eq,eqnc->en", Bq, qd, Bq)
                d = t if d is None else d + t
        else:
            import jax

            A_e = self._elem_mats()
            A_e = jax.vmap(self.tft, in_axes=1, out_axes=1)(A_e)
            A_e = jax.vmap(self.tft, in_axes=2, out_axes=2)(A_e)
            d = jnp.einsum("enn->en", A_e)
        if self.tf is None:
            d = d * self.signs * self.signs
        out = jnp.zeros(self.ndof, dtype=d.dtype)
        return out.at[self.gather.reshape(-1)].add(d.reshape(-1))

    def assemble_matrix(self):
        """Assembled scipy CSR cross-check (FULL level)."""
        import scipy.sparse as sp

        gm = np.asarray(self.gather, dtype=np.int64)
        ne, ndl = gm.shape
        A_e = self._elem_mats(xp=np)
        if self.tf is not None:
            T = self.space.dense_transform()           # (ne, ndl, ndl)
            A_e = np.einsum("eml,emn,ens->els", T, A_e, T)   # Tᵀ A T
        else:
            sg = np.asarray(self.signs)
            A_e = A_e * sg[:, :, None] * sg[:, None, :]
        rows = np.repeat(gm, ndl, axis=1).reshape(-1)
        cols = np.tile(gm, (1, ndl)).reshape(-1)
        return sp.coo_matrix(
            (A_e.reshape(-1), (rows, cols)), shape=(self.ndof, self.ndof)
        ).tocsr()


def _geom(mesh, nq1d, dtype):
    d2q = make_dof_to_quad(mesh.geom, 1, nq1d)
    X = element_node_coords(mesh, 1)
    return compute_geometric_factors(X, d2q, dtype=dtype)




def _mass_qd(gf, coeff, rt):
    """Mass qdata for a scalar, field, or (dim×dim) matrix coefficient
    (ex31-class anisotropic VectorFEMassIntegrator, fem/bilininteg.hpp:2704:
    matrix coefficients produce (ne, nq, d, d) qdata; the apply/diagonal
    paths contract them with the physical basis channels)."""
    w = gf.wdet
    if callable(coeff):
        C = jnp.asarray(coeff(gf.x), rt)
        if C.ndim == 4:
            return w[..., None, None] * C
        return w * C
    C = np.asarray(coeff)
    if C.ndim == 2:
        return w[..., None, None] * jnp.asarray(C, rt)[None, None]
    return float(coeff) * w


def build_nd_operator(
    space: NDSpace,
    mass_coeff: Optional[float] = 1.0,
    curlcurl_coeff: Optional[float] = None,
    nq1d: int = 3,
    dtype=None,
) -> VecFEOperator:
    """α (E, F) + β (curl E, curl F) on ND0."""
    mesh = space.mesh
    rt = real_t(dtype)
    gf = _geom(mesh, nq1d, dtype)
    from ..fem.fe_vector_simplex import VectorSimplexSpace, simplex_vec_element

    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(mesh.geom, "nd", space.order, 2 * nq1d - 1)
        pts, Bref, Cref = el["pts"], el["B"], el["D"]
    elif getattr(space, "kind", None) == "nd" and space.order >= 1:
        pts, Bref, Cref = nd_basis_ho(mesh.geom, space.order, nq1d)
    else:
        pts, Bref, Cref = nd0_basis(mesh.geom, nq1d)
    J, det = gf.jac, gf.det
    A = adjugate(J)
    terms = []
    if mass_coeff is not None:
        # E = J^{-T} Ê = adjᵀ Ê / det;  (E,F) qdata = w·det·(JᵀJ)^{-1} =
        # w/det · adj adjᵀ ... apply via physical basis directly:
        Bphys = jnp.einsum(
            "eqab,qna->eqnb", A / det[..., None, None], jnp.asarray(Bref, rt)
        )
        qd = _mass_qd(gf, mass_coeff, rt)
        terms.append(("mass", qd, Bphys))
    if curlcurl_coeff is not None:
        if mesh.dim == 3:
            Cphys = jnp.einsum(
                "eqab,qnb->eqna", J / det[..., None, None], jnp.asarray(Cref, rt)
            )
            # scalar, callable, or (3×3) MATRIX reluctivity — the curl is a
            # 3-channel field so matrix qdata contracts like vector-FE mass
            # (CurlCurlIntegrator(MatrixCoefficient&), fem/bilininteg.hpp:2808)
            qd = _mass_qd(gf, curlcurl_coeff, rt)
        else:
            Cphys = jnp.asarray(Cref, rt)[None] / det[..., None, None]
            Cphys = jnp.broadcast_to(
                Cphys, (mesh.ne,) + Cref.shape
            )
            # 2D: the curl is a scalar channel → scalar coefficient only
            if callable(curlcurl_coeff):
                qd = jnp.asarray(curlcurl_coeff(gf.x), rt) * gf.wdet
            else:
                qd = float(curlcurl_coeff) * gf.wdet
        terms.append(("curlcurl", qd, Cphys))
    return _make_op(space, terms, gf, rt)


def _make_op(space, terms, gf, rt):
    from ..fem.fe_vector_simplex import VectorSimplexSpace

    if isinstance(space, VectorSimplexSpace):
        return VecFEOperator(
            space=space,
            gather=jnp.asarray(space.gather_map, index_t()),
            signs=jnp.ones(space.gather_map.shape, rt),
            terms=tuple(terms),
            ndof=space.ndof,
            gf=gf,
            tf=space.transform,
            tft=space.transform_t,
        )
    return VecFEOperator(
        space=space,
        gather=jnp.asarray(space.gather_map, index_t()),
        signs=jnp.asarray(space.signs, rt),
        terms=tuple(terms),
        ndof=space.ndof,
        gf=gf,
    )


def build_rt_operator(
    space: RTSpace,
    mass_coeff: Optional[float] = 1.0,
    divdiv_coeff: Optional[float] = None,
    nq1d: int = 3,
    dtype=None,
) -> VecFEOperator:
    """α (u, v) + β (div u, div v) on RT0."""
    mesh = space.mesh
    rt = real_t(dtype)
    gf = _geom(mesh, nq1d, dtype)
    from ..fem.fe_vector_simplex import VectorSimplexSpace, simplex_vec_element

    if isinstance(space, VectorSimplexSpace):
        el = simplex_vec_element(mesh.geom, "rt", space.order, 2 * nq1d - 1)
        pts, Bref, Dref = el["pts"], el["B"], el["D"][..., 0]
    elif getattr(space, "kind", None) == "rt":
        pts, Bref, Dref = rt_basis_ho(mesh.geom, space.order - 1, nq1d)
    else:
        pts, Bref, Dref = rt0_basis(mesh.geom, nq1d)
    J, det = gf.jac, gf.det
    terms = []
    if mass_coeff is not None:
        Bphys = jnp.einsum(
            "eqab,qnb->eqna", J / det[..., None, None], jnp.asarray(Bref, rt)
        )
        qd = _mass_qd(gf, mass_coeff, rt)
        terms.append(("mass", qd, Bphys))
    if divdiv_coeff is not None:
        Dphys = (jnp.asarray(Dref, rt)[None] / det[..., None])[..., None]
        Dphys = jnp.broadcast_to(Dphys, (mesh.ne,) + Dref.shape + (1,))
        # div u is a scalar channel, so DivDivIntegrator takes a (possibly
        # spatially varying) scalar coefficient (fem/bilininteg.hpp:3130)
        if callable(divdiv_coeff):
            qd = jnp.asarray(divdiv_coeff(gf.x), rt) * gf.wdet
        else:
            qd = float(divdiv_coeff) * gf.wdet
        terms.append(("divdiv", qd, Dphys))
    return _make_op(space, terms, gf, rt)


def vecfe_linear_form(op: VecFEOperator, vec_fn: Callable) -> jnp.ndarray:
    """(c, φ) RHS vector for a vector coefficient c(x) (VectorFEDomainLF,
    fem/lininteg.hpp:364).  Uses the operator's mass term's physical basis."""
    return _vecfe_lf_against(op, "mass", vec_fn)


def vecfe_linear_form_curl(op: VecFEOperator, fn: Callable) -> jnp.ndarray:
    """(f, curl φ) RHS (VectorFEDomainLFCurl, fem/lininteg.hpp:393).

    ``fn(x)`` returns a 3-vector in 3D or a scalar in 2D (where curl is
    scalar).  Requires the operator to carry a curlcurl term (its physical
    curl basis is reused)."""
    return _vecfe_lf_against(op, "curlcurl", fn)


def vecfe_linear_form_div(op: VecFEOperator, fn: Callable) -> jnp.ndarray:
    """(f, div φ) RHS for RT spaces (VectorFEDomainLFDiv,
    fem/lininteg.hpp:417).  ``fn(x)`` is scalar; requires a divdiv term."""
    return _vecfe_lf_against(op, "divdiv", fn)


def _vecfe_lf_against(op: VecFEOperator, term: str, fn: Callable):
    try:
        _, _qd, Bq = next(t for t in op.terms if t[0] == term)
    except StopIteration:
        raise ValueError(
            f"operator has no {term!r} term; build it with the matching "
            f"coefficient to expose the physical basis")
    f = jnp.asarray(fn(np.asarray(op.gf.x)), Bq.dtype)
    if f.ndim == Bq.ndim - 2:                    # scalar data for c=1 terms
        f = f[..., None]
    v = jnp.einsum("eqnc,eqc->en", Bq, op.gf.wdet[..., None] * f)
    v = op._post(v)
    out = jnp.zeros(op.ndof, dtype=Bq.dtype)
    return out.at[op.gather.reshape(-1)].add(v.reshape(-1))


# ----------------------------------------------------------------------------
# discrete de Rham operators (ex24 DiscreteLinearOperator analogs)
# ----------------------------------------------------------------------------


def discrete_gradient(h1_fes, nd_space: NDSpace):
    """G: H1(order 1) → ND0, (Gu)_edge = u(max) − u(min) (∫ ∇u·t dl)."""
    from ..mesh.mesh import unique_edges

    edges, _ = unique_edges(nd_space.mesh)
    # H1 order-1 dofs are keyed by vertex — map vertex id → dof id
    vmap = _vertex_dof_map(h1_fes)
    lo = vmap[edges[:, 0]]
    hi = vmap[edges[:, 1]]
    lo, hi = jnp.asarray(lo, index_t()), jnp.asarray(hi, index_t())

    def G(u):
        return u[hi] - u[lo]

    return G


def discrete_curl(nd_space: NDSpace, rt_space: RTSpace):
    """C: ND0 → RT0 (3D), (CE)_face = ∫_f curl E·n = ∮_∂f E·t — the signed
    sum of the face's boundary edge dofs in the face's canonical cycle
    (DiscreteLinearOperator curl, ex24 analog).  With discrete_gradient this
    completes the de Rham sequence: div∘curl = 0, curl∘grad = 0."""
    from ..mesh.mesh import unique_edges, unique_faces
    from ..fem.geometry import FACES

    mesh = nd_space.mesh
    assert mesh.dim == 3
    edges, _ = unique_edges(mesh)
    edge_id = {tuple(e): i for i, e in enumerate(map(tuple, edges))}
    faces, elem_face = unique_faces(mesh)
    nfaces = len(faces)

    # canonical cycle per unique face from its first incident element (the
    # canonical frame is element-independent; for tri faces the argmin
    # cycle equals the sorted triple — the RTSpace normal convention)
    loc_faces = FACES[mesh.geom]
    nfv = len(loc_faces[0])
    cyc = np.zeros((nfaces, nfv), dtype=np.int64)
    seen = np.zeros(nfaces, dtype=bool)
    for e in range(mesh.ne):
        for lf, fverts in enumerate(loc_faces):
            fid = elem_face[e, lf]
            if seen[fid]:
                continue
            gids = mesh.elements[e, list(fverts)]
            k = len(gids)
            r = int(np.argmin(gids))
            d = 1 if gids[(r + 1) % k] < gids[(r - 1) % k] else -1
            cyc[fid] = [gids[(r + d * i) % k] for i in range(k)]
            seen[fid] = True

    edge_ids = np.zeros((nfaces, nfv), dtype=np.int64)
    signs = np.zeros((nfaces, nfv))
    for i in range(nfaces):
        for j in range(nfv):
            a, b = int(cyc[i, j]), int(cyc[i, (j + 1) % nfv])
            edge_ids[i, j] = edge_id[(a, b) if a < b else (b, a)]
            signs[i, j] = 1.0 if a < b else -1.0

    import jax.numpy as jnp

    eid = jnp.asarray(edge_ids, index_t())
    sg = jnp.asarray(signs)

    def C(E):
        return jnp.sum(E[eid] * sg, axis=1)

    return C


def discrete_divergence(rt_space: RTSpace, l2_fes=None):
    """D: RT0 → P0(L2), (Du)|_K = (Σ outward-signed face dofs)/|K| — exact
    since div u is constant per element for RT0 (DiscreteLinearOperator
    divergence, ex24 analog; completes the de Rham chain with
    discrete_gradient/discrete_curl: D∘C = 0 identically)."""
    import jax.numpy as jnp

    from ..fem.basis import make_dof_to_quad
    from ..fem.fespace import element_node_coords
    from ..fem.geom_factors import compute_geometric_factors

    mesh = rt_space.mesh
    d2q = make_dof_to_quad(mesh.geom, 1, 2)
    X = element_node_coords(mesh, 1)
    gf = compute_geometric_factors(X, d2q)
    vol = jnp.sum(gf.wdet, axis=1)                  # (ne,)
    gm = jnp.asarray(rt_space.gather_map, index_t())
    sg = jnp.asarray(rt_space.signs)

    def D(u):
        flux = jnp.sum(u[gm] * sg, axis=1)          # ∫_K div u
        return flux / vol                            # constant P0 value

    return D


def vertex_dof_positions(mesh) -> np.ndarray:
    """Per-element local-dof position of each element VERTEX in the lex
    order-1 dof ordering: dofpos[v] = lex node index of vertex v (shared by
    the AMS tables, the vertex dof map, and VisIt restriction)."""
    from ..fem.fespace import element_node_coords

    X0 = element_node_coords(mesh, 1)[0]
    V0 = mesh.vertices[mesh.elements[0]]
    vtx_of_dof = np.array([
        int(np.argmin(((V0 - X0[n]) ** 2).sum(axis=1)))
        for n in range(X0.shape[0])
    ])
    assert len(np.unique(vtx_of_dof)) == len(vtx_of_dof)
    dofpos = np.empty_like(vtx_of_dof)
    dofpos[vtx_of_dof] = np.arange(len(vtx_of_dof))
    return dofpos


def _vertex_dof_map(h1_fes) -> np.ndarray:
    """vertex id → H1 order-1 scalar dof id.

    The space's local dof order (lexicographic) is a PERMUTATION of the
    element vertex order on tensor geometries (hex vertex 2 is lex dof 3,
    …), so the columns must be aligned by matching local-node coordinates
    against the element's vertex coordinates before scattering."""
    from ..fem.fespace import element_node_coords

    mesh = h1_fes.mesh
    assert h1_fes.order == 1
    X0 = element_node_coords(mesh, 1)[0]          # (ndl, sdim) local coords
    V0 = mesh.vertices[mesh.elements[0]]          # (nv_el, sdim)
    vtx_of_dof = np.array([
        int(np.argmin(((V0 - X0[n]) ** 2).sum(axis=1)))
        for n in range(X0.shape[0])
    ])
    assert len(np.unique(vtx_of_dof)) == len(vtx_of_dof)
    out = np.zeros(mesh.nv, dtype=np.int64)
    out[mesh.elements[:, vtx_of_dof].reshape(-1)] = \
        h1_fes.gather_map.reshape(-1)
    return out


# ----------------------------------------------------------------------------
# boundary linear forms
# ----------------------------------------------------------------------------


def _face_chart(geom, pts: np.ndarray):
    """P1/Q1 face chart shape values N (nq, nv) and gradients G (nq, nv, 2)
    in REF_VERTS vertex order."""
    from ..fem.geometry import Geometry

    u, v = pts[:, 0], pts[:, 1]
    if geom == Geometry.TRIANGLE:
        N = np.stack([1 - u - v, u, v], axis=1)
        G = np.broadcast_to(
            np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]),
            (len(pts), 3, 2)).copy()
        return N, G
    if geom == Geometry.SQUARE:
        N = np.stack([(1 - u) * (1 - v), u * (1 - v), u * v, (1 - u) * v],
                     axis=1)
        Gu = np.stack([-(1 - v), (1 - v), v, -v], axis=1)
        Gv = np.stack([-(1 - u), -u, u, (1 - u)], axis=1)
        return N, np.stack([Gu, Gv], axis=2)
    raise ValueError(geom)


def _chart_outward_signs(mesh, bdr: np.ndarray, x: np.ndarray,
                         J: np.ndarray) -> np.ndarray:
    """+1 where the face chart's normal cross(J₀,J₁) points OUT of the
    volume, −1 where it points in (per-face; centroid test)."""
    nc = np.cross(J[:, :, :, 0], J[:, :, :, 1]).mean(axis=1)   # (nbf, 3)
    vmap = {}
    for e in range(mesh.ne):
        for vtx in mesh.elements[e]:
            vmap.setdefault(int(vtx), []).append(e)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    s = np.ones(len(bdr))
    for f in range(len(bdr)):
        fset = set(int(vv) for vv in bdr[f])
        e = next(c for c in vmap[int(bdr[f, 0])]
                 if fset.issubset(set(int(vv) for vv in mesh.elements[c])))
        if np.dot(nc[f], x[f].mean(axis=0) - cent[e]) < 0:
            s[f] = -1.0
    return s


def nd_boundary_tangent_lf(space: NDSpace, vec_fn, bdr_marker=None,
                           nq1d: int = 3, dtype=None) -> jnp.ndarray:
    """∮ (n × f)·v over marked boundary faces of a 3D mesh for the ND0 test
    space (VectorFEBoundaryTangentLFIntegrator, fem/lininteg.hpp:511, impl
    lininteg.cpp:708) — the port-excitation RHS of ex35-class problems.

    H(curl) conformity makes the tangential trace of the volume ND0 basis on
    a boundary face equal the face's own 2D ND0 basis in the face chart, so
    assembly runs entirely on the face mesh: per quad point pull f back
    covariantly (f̂ = J_faceᵀ f, which carries the area measure), rotate 90°
    in the chart ((a, b) → (−b, a) ≡ n×f for an outward chart), contract
    with the reference edge basis, and scatter to global edge dofs with
    min→max orientation signs.  Identity check (tests/test_vecfe_lf.py):
    for constant c, b = −(∇×φ, c) exactly."""
    from ..fem.geometry import EDGES as _EDGES
    from ..fem.intrules import simplex_rule, tensor_rule
    from ..mesh.mesh import unique_edges

    mesh = space.mesh
    rt = real_t(dtype)
    if mesh.dim != 3:
        raise NotImplementedError("nd_boundary_tangent_lf: 3D meshes only")
    if getattr(space, "order", 1) != 1 or isinstance(space, RTSpace):
        raise NotImplementedError("nd_boundary_tangent_lf: ND0 spaces only")
    if mesh.nbe == 0:
        return jnp.zeros(space.ndof, dtype=rt)
    bdr = mesh.boundary
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        bdr = bdr[sel]
        if len(bdr) == 0:
            return jnp.zeros(space.ndof, dtype=rt)
    fgeom = mesh.bdr_geom
    from ..fem.geometry import Geometry

    pts, B2, _ = nd0_basis(fgeom, nq1d)                 # face reference basis
    if fgeom == Geometry.TRIANGLE:
        _, w = simplex_rule(2, 2 * nq1d - 1)            # matches nd0_basis
    else:
        _, w = tensor_rule(2, nq1d)
    N, G = _face_chart(fgeom, pts)
    X = mesh.vertices[bdr]                              # (nbf, nv, 3)
    J = np.einsum("qvd,fvs->fqsd", G, X)                # (nbf, nq, 3, 2)
    x = np.einsum("qv,fvs->fqs", N, X)                  # (nbf, nq, 3)
    f = np.broadcast_to(np.asarray(vec_fn(x) if callable(vec_fn) else vec_fn,
                                   np.float64), x.shape)
    fh = np.einsum("fqsd,fqs->fqd", J, f)               # Jᵀ f
    rot = np.stack([-fh[..., 1], fh[..., 0]], axis=-1)  # chart rep of n×f
    s = _chart_outward_signs(mesh, bdr, x, J)
    elv = np.einsum("qkd,fqd,q->fk", B2, rot, w) * s[:, None]
    # face-local edges → global edge dofs + min→max orientation signs
    edges, _ = unique_edges(mesh)
    base = np.int64(mesh.nv + 1)
    ekey = edges[:, 0].astype(np.int64) * base + edges[:, 1]
    order = np.argsort(ekey)
    loc = np.array(_EDGES[fgeom])
    fa, fb = bdr[:, loc[:, 0]], bdr[:, loc[:, 1]]       # (nbf, nk) global ids
    key = np.minimum(fa, fb).astype(np.int64) * base + np.maximum(fa, fb)
    gid = order[np.searchsorted(ekey[order], key)]
    sgn = np.where(fa < fb, 1.0, -1.0)
    b = np.zeros(space.ndof)
    np.add.at(b, gid.reshape(-1), (elv * sgn).reshape(-1))
    return jnp.asarray(b, rt)
