"""BilinearForm: the operator-assembly front-end.

Reference analog: ``BilinearForm`` (``fem/bilinearform.hpp:60``) with
``AddDomainIntegrator`` / ``AddBoundaryIntegrator`` / ``Assemble`` /
``FormLinearSystem`` and the ``AssemblyLevel`` engines
(``fem/bilinearform_ext.hpp``):

* **PARTIAL** (the default here): precompute qdata per
  integrator, apply matrix-free as R→(sum of integrator applies)→Rᵀ
  (``PABilinearFormExtension::MultInternal``, fem/bilinearform_ext.cpp:487).
  Boundary integrators run the same pipeline through the boundary-face
  restriction and the face geometric factors.
* **FULL**: assemble a host-side scipy CSR matrix from batched element
  matrices (``FABilinearFormExtension`` / legacy path) — the assembly-level
  cross-check harness (tests/unit/fem/test_assembly_levels.cpp analog) and
  the LOR building block.

Integrators are registered by name; each provides setup/apply/diagonal (see
``ops/mass.py``, ``ops/diffusion.py``, ...).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..fem.basis import make_dof_to_quad
from ..fem.build import (
    basis_for,
    bdr_restriction_for,
    geom_factors_for,
    restriction_for,
)
from ..fem.coefficient import eval_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import DeviceBasis, device_basis
from ..fem.restriction import ElementRestriction
from ..utils.config import real_t
from . import convection, diffusion, elasticity, lanemajor, mass
from .operators import LinearOperator

_INTEGRATORS = {
    "mass": mass,
    "diffusion": diffusion,
    "convection": convection,
    "elasticity": elasticity,   # coeff = (lambda, mu) pair
}


def register_integrator(name: str, module) -> None:
    """Extension hook: module must provide setup/apply/diagonal."""
    _INTEGRATORS[name] = module


@dataclasses.dataclass
class _Term:
    kind: str
    coeff: object = None
    vector_coeff: object = None
    boundary: bool = False
    marker: Optional[Sequence[int]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class _BoundTerm:
    """One integrator bound to its restriction/basis/qdata."""

    mod: object
    qdata: jnp.ndarray
    restr: ElementRestriction
    db: DeviceBasis


@dataclasses.dataclass(frozen=True, eq=False)
class _LaneGroup:
    """Domain terms fused into one lane-major pass (see ops/lanemajor.py):
    one L→E gather, all applies as (nq×nd)@(nd, ne) matmuls, one E→L
    scatter.  ``terms`` hold setup-time-transposed qdata; ``aff_terms``
    hold affine-separable terms collapsed to per-element factors (the
    qdata stream drops nq-fold and the apply becomes one stacked
    reference-matrix matmul — detected numerically, curved meshes fall
    back to ``terms``)."""

    lb: lanemajor.LaneBasis
    restr: ElementRestriction
    terms: Tuple[Tuple[str, jnp.ndarray], ...]
    af: Optional[lanemajor.AffineOps] = None
    aff_terms: Tuple[Tuple[str, jnp.ndarray], ...] = ()


@dataclasses.dataclass(frozen=True, eq=False)
class PAOperator:
    """Assembled partial-assembly operator:
    y = Σ_terms Rᵀ_t apply_t(qdata_t, R_t x).

    ``terms`` always holds every integrator (diagonal assembly, FULL
    cross-checks); ``lane`` + ``std_terms``, when set, partition them for
    ``mult`` into the fused lane-major group and the per-term fallback."""

    terms: Tuple[_BoundTerm, ...]
    ndof: int
    vdim: int = 1
    lane: Optional[_LaneGroup] = None
    std_terms: Tuple[_BoundTerm, ...] = ()

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.vdim > 1:
            xl = x.reshape(self.vdim, self.ndof).T       # (ndof, vdim) byNODES
        else:
            xl = x
        out = None
        if self.lane is not None:
            eT = self.lane.restr.mult_t(xl)              # (nd, ne)
            yT = lanemajor.apply_terms(
                self.lane.lb, self.lane.terms, eT,
                af=self.lane.af, aff_terms=self.lane.aff_terms,
            )
            out = self.lane.restr.mult_transpose_t(yT)
        std = self.std_terms if self.lane is not None else self.terms
        for t in std:
            e = t.restr.mult(xl)
            y = t.restr.mult_transpose(t.mod.apply(t.db, t.qdata, e))
            out = y if out is None else out + y
        if self.vdim > 1:
            return out.T.reshape(-1)
        return out

    def diagonal(self) -> jnp.ndarray:
        out = None
        for t in self.terms:
            d = t.restr.mult_transpose(t.mod.diagonal(t.db, t.qdata))
            if self.vdim > 1 and d.ndim == 1:
                d = jnp.tile(d[:, None], (1, self.vdim))  # component-agnostic
            out = d if out is None else out + d
        if self.vdim > 1:
            return out.T.reshape(-1)
        return out

    def operator(self) -> LinearOperator:
        n = self.ndof * self.vdim
        return LinearOperator((n, n), self.mult, self.diagonal)


@functools.lru_cache(maxsize=None)
def _bdr_geom_cached(fes, nq1d, dtype_str):
    """Boundary-face geometric factors + device basis (face mesh pipeline)."""
    from ..mesh.mesh import Mesh

    mesh = fes.mesh
    p = fes.order
    d2q = make_dof_to_quad(mesh.bdr_geom, p, nq1d or (p + 2))
    bmesh = Mesh(
        geom=mesh.bdr_geom,
        vertices=mesh.vertices,
        elements=mesh.boundary,
        attributes=mesh.bdr_attributes,
        boundary=np.zeros((0, 1), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
    )
    X = element_node_coords(bmesh, p)
    gf = compute_geometric_factors(X, d2q, dtype=dtype_str)
    return gf, device_basis(d2q, dtype_str)


class BilinearForm:
    """Front-end mirroring the reference API shape (fem/bilinearform.hpp:60)."""

    def __init__(self, fes, nq1d: Optional[int] = None):
        self.fes = fes
        self.nq1d = nq1d
        self._terms: List[_Term] = []

    def add_domain_integrator(self, kind: str, coeff=None, vector_coeff=None):
        if kind not in _INTEGRATORS:
            raise ValueError(
                f"unknown integrator {kind!r}; have {sorted(_INTEGRATORS)}"
            )
        self._terms.append(_Term(kind, coeff, vector_coeff))
        return self

    def add_boundary_integrator(self, kind: str, coeff=None, marker=None):
        """Boundary terms, e.g. 'mass' for Robin (σu, v)_∂Ω
        (BoundaryMassIntegrator analog)."""
        if kind != "mass":
            raise NotImplementedError(
                "boundary integrators: only 'mass' (Robin) so far"
            )
        self._terms.append(_Term(kind, coeff, boundary=True, marker=marker))
        return self

    # ------------------------------------------------------------------
    def assemble(self, dtype=None) -> PAOperator:
        """PARTIAL assembly: build qdata, return the matrix-free operator."""
        fes = self.fes
        bound: List[_BoundTerm] = []
        for t in self._terms:
            mod = _INTEGRATORS[t.kind]
            if t.boundary:
                gf, db = _bdr_geom_cached(fes, self.nq1d, str(real_t(dtype)))
                restr = bdr_restriction_for(fes)
                cq = eval_coeff(t.coeff, gf, dtype)
                qd = mod.setup(gf, cq)
                if t.marker is not None:
                    sel = np.isin(
                        fes.mesh.bdr_attributes, np.asarray(list(t.marker))
                    )
                    qd = qd * jnp.asarray(sel, dtype=qd.dtype)[:, None]
            else:
                gf = geom_factors_for(fes, self.nq1d, dtype)
                db = basis_for(fes, self.nq1d, dtype)
                restr = restriction_for(fes)
                if t.kind == "elasticity":
                    lam, mu = t.coeff if t.coeff is not None else (None, None)
                    qd = mod.setup(
                        gf, eval_coeff(lam, gf, dtype), eval_coeff(mu, gf, dtype)
                    )
                elif t.vector_coeff is not None:
                    cq = eval_coeff(t.coeff, gf, dtype)
                    vq = _eval_vector_coeff(t.vector_coeff, gf, dtype)
                    qd = mod.setup(gf, cq, vq)
                elif t.kind == "diffusion":
                    cq = eval_coeff(t.coeff, gf, dtype)
                    if cq is None or cq.ndim == 2:
                        # packed symmetric storage: 2/3 of the traffic
                        qd = mod.setup_packed(gf, cq)
                    else:
                        qd = mod.setup(gf, cq)
                else:
                    qd = mod.setup(gf, eval_coeff(t.coeff, gf, dtype))
            bound.append(_BoundTerm(mod=mod, qdata=qd, restr=restr, db=db))
        lane, std = _build_lane_group(self._terms, bound, fes.vdim, fes)
        return PAOperator(
            terms=tuple(bound), ndof=fes.ndof_scalar, vdim=fes.vdim,
            lane=lane, std_terms=std,
        )

    def assemble_ell(self, dtype=None):
        """FULL assembly to a device ELL operator (:mod:`.ell`).

        The p1-simplex fast path: at order 1 the matrix-free pipeline is
        scatter-bound (every dof is a high-multiplicity vertex dof) while
        the assembled matrix is tiny (nnz/row ≈ 15) and applies as J fixed
        weighted gathers with no scatter at all — the reference's own
        choice of the LEGACY/FULL CSR path at low order
        (``fem/bilinearform.cpp``)."""
        from .ell import ELLOperator

        from ..utils.config import real_t

        return ELLOperator.from_csr(
            self.assemble_matrix(dtype), str(real_t(dtype)))

    def _assemble_elasticity_matrix(self, dtype=None):
        return _assemble_elasticity_matrix_impl(
            self.fes, self.nq1d, self._terms[0], dtype
        )

    # ------------------------------------------------------------------
    def assemble_matrix(self, dtype=None):
        """FULL assembly to scipy CSR (reference LEGACY/FULL levels).

        Runs on the CPU backend when available: this is a host setup path
        whose result is a scipy matrix, so computing it on an accelerator
        would only add two transfers and hold its (ne, nd, nd) element
        matrices in device memory the solver needs."""
        try:
            import jax

            cpus = jax.devices("cpu")
        except RuntimeError:
            cpus = None
        if cpus and jax.default_backend() != "cpu":
            with jax.default_device(cpus[0]):
                return self._assemble_matrix_impl(dtype)
        return self._assemble_matrix_impl(dtype)

    def _assemble_matrix_impl(self, dtype=None):
        import scipy.sparse as sp

        fes = self.fes
        n = fes.ndof_scalar
        if any(t.kind == "elasticity" for t in self._terms):
            if len(self._terms) != 1:
                raise NotImplementedError("elasticity must be the sole term")
            return self._assemble_elasticity_matrix(dtype)
        A = sp.csr_matrix((n, n))
        for t in self._terms:
            mod = _INTEGRATORS[t.kind]
            if t.boundary:
                gf, _db = _bdr_geom_cached(fes, self.nq1d, str(real_t(dtype)))
                d2q = make_dof_to_quad(
                    fes.mesh.bdr_geom, fes.order, self.nq1d or (fes.order + 2)
                )
                gmap = fes.bdr_gather_map.astype(np.int64)
            else:
                gf = geom_factors_for(fes, self.nq1d, dtype)
                d2q = fes.dof_to_quad(self.nq1d)
                gmap = fes.gather_map.astype(np.int64)
            B = d2q.full_B()
            G = d2q.full_G()
            cq = eval_coeff(t.coeff, gf, dtype)
            if t.vector_coeff is not None:
                vq = _eval_vector_coeff(t.vector_coeff, gf, dtype)
                qd = np.asarray(mod.setup(gf, cq, vq))
            else:
                qd = np.asarray(mod.setup(gf, cq))
            if t.boundary and t.marker is not None:
                sel = np.isin(
                    fes.mesh.bdr_attributes, np.asarray(list(t.marker))
                )
                qd = qd * sel[:, None]
            A_e = _element_matrices(t.kind, B, G, qd)
            ne, nd = gmap.shape
            rows = np.repeat(gmap, nd, axis=1).reshape(-1)
            cols = np.tile(gmap, (1, nd)).reshape(-1)
            A = A + sp.coo_matrix(
                (A_e.reshape(-1), (rows, cols)), shape=(n, n)
            ).tocsr()
        if fes.vdim > 1:
            A = sp.block_diag([A] * fes.vdim).tocsr()
        return A


def _geom_affine_term(t: _Term, geo, dt):
    """Affine factors for one term from host-f64 geometry, or None.
    Needs constant scalar ``coeff`` (constant vector for convection)."""
    det, dk, adj = geo
    c = t.coeff
    if c is None:
        cs = 1.0
    elif not callable(c) and np.ndim(c) == 0:
        cs = float(c)
    else:
        return None
    if t.kind == "mass" and t.vector_coeff is None:
        return jnp.asarray(cs * det, dt)[None, :]
    if t.kind == "diffusion" and t.vector_coeff is None:
        return jnp.asarray(cs * dk, dt)
    if t.kind == "convection" and t.vector_coeff is not None:
        v = t.vector_coeff
        if callable(v):
            return None
        v = np.asarray(v, np.float64)
        if v.ndim != 1:
            return None
        # (v·∇u, w): qdata = w_q ⊗ (adj(J) v) per element
        return jnp.asarray(cs * np.einsum("eds,s->de", adj, v), dt)
    return None


def _build_lane_group(terms, bound, vdim, fes=None):
    """Partition assembled terms into a fused lane-major group + fallbacks.

    Eligible: scalar (vdim=1) domain mass/diffusion/convection terms sharing
    one restriction and basis, with lane-supported qdata layouts, under the
    ``config.lane_major`` knob ("auto" enables whenever supported).

    Affine-separable terms collapse further (see ops/lanemajor.py): on
    straight-simplex meshes with constant coefficients the factors come
    from host-f64 geometry (f32 qdata on sliver elements carries ~1e-3
    adjugate roundoff that defeats the numerical check); elsewhere the
    numerical W⊗d detector catches lattice hexes and f64 runs."""
    from ..utils.config import config

    if getattr(config, "lane_major", "auto") == "off" or vdim > 1:
        return None, ()
    geo = None
    if fes is not None and getattr(config, "affine_collapse", "auto") != "off":
        from ..fem.geom_factors import (
            _np_det_adj,
            affine_element_jacobians,
            affine_packed_factors,
        )

        J = affine_element_jacobians(fes.mesh)
        if J is not None:
            det, dk = affine_packed_factors(J)
            geo = (det, dk, _np_det_adj(J)[1])
    lane_terms, aff_terms, std = [], [], []
    restr = db = None
    for t, bt in zip(terms, bound):
        ok = (
            not t.boundary
            and t.kind in ("mass", "diffusion", "convection")
            and lanemajor.supports(bt.db, bt.qdata, t.kind)
            and (restr is None or bt.restr is restr)
            and (db is None or bt.db is db)
        )
        if ok:
            restr, db = bt.restr, bt.db
            d = _geom_affine_term(t, geo, bt.qdata.dtype) \
                if geo is not None else None
            qT = None
            if d is None:
                qT = lanemajor.transpose_qdata(t.kind, bt.qdata)
                d = lanemajor.try_affine(t.kind, qT, bt.db)
            if d is not None:
                aff_terms.append((t.kind, d))
            else:
                lane_terms.append((t.kind, qT))
        else:
            std.append(bt)
    if not lane_terms and not aff_terms:
        return None, ()
    return (
        _LaneGroup(lb=lanemajor.lane_basis(db), restr=restr,
                   terms=tuple(lane_terms),
                   af=lanemajor.affine_ops(db) if aff_terms else None,
                   aff_terms=tuple(aff_terms)),
        tuple(std),
    )


def _assemble_elasticity_matrix_impl(fes, nq1d, term, dtype):
    import scipy.sparse as sp

    gf = geom_factors_for(fes, nq1d, dtype)
    d2q = fes.dof_to_quad(nq1d)
    G = d2q.full_G()                                 # (nq, nd, dim)
    lam_c, mu_c = term.coeff if term.coeff is not None else (None, None)
    lam = np.asarray(eval_coeff(lam_c, gf, dtype)) if lam_c is not None else 1.0
    mu = np.asarray(eval_coeff(mu_c, gf, dtype)) if mu_c is not None else 1.0
    from ..fem.geom_factors import adjugate as _adj

    A = np.asarray(_adj(gf.jac))
    det = np.asarray(gf.det)
    w = np.asarray(gf.w)
    # physical gradients Gp[e,q,n,a] = Σ_r adj[r,a] G[q,n,r] / det
    Gp = np.einsum("eqra,qnr->eqna", A, G) / det[..., None, None]
    wdet = w[None, :] * det
    lam_q = lam * wdet
    mu_q = mu * wdet
    dim = Gp.shape[-1]
    nd = Gp.shape[2]
    # elmat[(c,m),(d,n)]
    div = np.einsum("eq,eqma,eqnb->emanb", lam_q, Gp, Gp)      # λ ∂_c u ∂_d v
    cross = np.einsum("eq,eqma,eqnb->emanb", mu_q, Gp, Gp)
    lap = np.einsum("eq,eqma,eqna->emn", mu_q, Gp, Gp)
    ne = Gp.shape[0]
    elmat = np.zeros((ne, dim, nd, dim, nd))
    for c in range(dim):
        for d in range(dim):
            elmat[:, c, :, d, :] = (
                div[:, :, c, :, d] + cross[:, :, d, :, c]
            )
            if c == d:
                elmat[:, c, :, d, :] += lap
    gm = fes.gather_map.astype(np.int64)
    ndof = fes.ndof_scalar
    gidx = gm[:, None, :] + ndof * np.arange(dim)[None, :, None]  # (ne,dim,nd)
    gflat = gidx.reshape(ne, dim * nd)
    rows = np.repeat(gflat, dim * nd, axis=1).reshape(-1)
    cols = np.tile(gflat, (1, dim * nd)).reshape(-1)
    M = sp.coo_matrix(
        (elmat.reshape(-1), (rows, cols)), shape=(ndof * dim, ndof * dim)
    ).tocsr()
    return M


def _element_matrices(kind: str, B, G, qd) -> np.ndarray:
    if kind == "mass":
        return np.einsum("qm,eq,qn->emn", B, qd, B, optimize=True)
    if kind == "diffusion":
        return np.einsum("qma,eqab,qnb->emn", G, qd, G, optimize=True)
    if kind == "convection":
        # qd: (ne, nq, dim) — (v·grad u, w)
        return np.einsum("qm,eqa,qna->emn", B, qd, G, optimize=True)
    raise NotImplementedError(f"element matrices for {kind}")


def _eval_vector_coeff(coeff, gf, dtype=None):
    if callable(coeff):
        return jnp.asarray(coeff(gf.x), dtype=real_t(dtype))
    arr = jnp.asarray(coeff, dtype=real_t(dtype))
    if arr.ndim == 1:  # constant vector
        ne, nq = gf.det.shape
        return jnp.broadcast_to(arr[None, None, :], (ne, nq, arr.shape[0]))
    return arr
