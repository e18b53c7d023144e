"""LinearForm: RHS vector assembly.

Reference analog: ``LinearForm`` (``fem/linearform.hpp:24``) with
``DomainLFIntegrator`` / ``BoundaryLFIntegrator`` (``fem/lininteg.hpp:107,192``)
and the device fast path ``fem/integ/lininteg_domain*.cpp``.

Design: (f, v) = Rᵀ Bᵀ (w·detJ·f(x_q)) in two einsum contractions;
boundary terms run the same pipeline on the boundary-face "mesh" (the
boundary elements with their own lower-dimensional geometry and the
``bdr_gather_map`` restriction into volume L-dofs).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..fem.build import bdr_restriction_for, restriction_for
from ..fem.basis import make_dof_to_quad
from ..fem.coefficient import eval_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_values_t, eval_grad_t
from ..fem.build import basis_for, geom_factors_for
from ..mesh.mesh import Mesh
from ..utils.config import real_t
import functools


def domain_lf(fes, coeff, nq1d: Optional[int] = None, dtype=None) -> jnp.ndarray:
    """(f, v) over the domain → L-vector (DomainLFIntegrator, lininteg.hpp:107)."""
    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    fq = eval_coeff(coeff, gf, dtype)
    q = gf.wdet if fq is None else gf.wdet * fq
    b_e = eval_values_t(db, q)
    return restriction_for(fes).mult_transpose(b_e)


def domain_lf_from_qvec(fes, fq: jnp.ndarray, nq1d=None, dtype=None) -> jnp.ndarray:
    """(f, v) with f given as an (ne, nq) Q-vector (QuadratureLFIntegrator)."""
    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    b_e = eval_values_t(db, gf.wdet * fq)
    return restriction_for(fes).mult_transpose(b_e)


@functools.lru_cache(maxsize=None)
def _bdr_geom(fes, nq1d, dtype_str):
    """Geometric factors + device basis of the boundary-face mesh."""
    mesh = fes.mesh
    bgeom = mesh.bdr_geom
    p = fes.order
    d2q = make_dof_to_quad(bgeom, p, nq1d or (p + 2))
    # boundary element node coords via Q1/P1 map of face vertices
    bmesh = Mesh(
        geom=bgeom,
        vertices=mesh.vertices,
        elements=mesh.boundary,
        attributes=mesh.bdr_attributes,
        boundary=np.zeros((0, 1), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
    )
    X = element_node_coords(bmesh, p)
    gf = compute_geometric_factors(X, d2q, dtype=dtype_str)
    db = device_basis(d2q, dtype_str)
    return gf, db


def domain_lf_vector(fes, vec, nq1d: Optional[int] = None,
                     dtype=None) -> jnp.ndarray:
    """(f, v) for vector f on a vdim space → byNODES flat vector
    (VectorDomainLFIntegrator, lininteg.hpp:267) — body forces etc."""
    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    rt = real_t(dtype)
    if callable(vec):
        fq = jnp.asarray(vec(gf.x), rt)
    else:
        arr = jnp.asarray(vec, rt)
        ne, nq = gf.det.shape
        fq = jnp.broadcast_to(arr[None, None, :], (ne, nq, arr.shape[0]))
    b_e = eval_values_t(db, gf.wdet[..., None] * fq)      # (ne, nd, vdim)
    b = restriction_for(fes).mult_transpose(b_e)          # (ndof, vdim)
    return b.T.reshape(-1)


def boundary_lf_vector(
    fes, vec, bdr_marker=None, nq1d: Optional[int] = None, dtype=None
) -> jnp.ndarray:
    """(f, v)_∂Ω for vector f on a vdim space → (ndof_scalar·vdim,) byNODES
    (VectorBoundaryLFIntegrator, lininteg.hpp:339)."""
    mesh = fes.mesh
    rt = real_t(dtype)
    if mesh.nbe == 0:
        return jnp.zeros(fes.ndof, dtype=rt)
    gf, db = _bdr_geom(fes, nq1d, str(rt))
    if callable(vec):
        fq = jnp.asarray(vec(gf.x), dtype=rt)           # (nbe, nq, vdim)
    else:
        arr = jnp.asarray(vec, dtype=rt)
        nbe, nq = gf.det.shape
        fq = jnp.broadcast_to(arr[None, None, :], (nbe, nq, arr.shape[0]))
    q = gf.wdet[..., None] * fq
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        q = q * jnp.asarray(sel.astype(float), dtype=rt)[:, None, None]
    b_e = eval_values_t(db, q)                           # (nbe, ndf, vdim)
    b = bdr_restriction_for(fes).mult_transpose(b_e)     # (ndof_scalar, vdim)
    return b.T.reshape(-1)


def boundary_lf(
    fes, coeff, bdr_marker=None, nq1d: Optional[int] = None, dtype=None
) -> jnp.ndarray:
    """(g, v) over marked boundary faces (BoundaryLFIntegrator, lininteg.hpp:192).

    The face Jacobian is rectangular (sdim × dim-1); ``detJ`` is the surface
    measure sqrt(det(JᵀJ)) — see geom_factors.determinant.
    """
    mesh = fes.mesh
    if mesh.nbe == 0:
        return jnp.zeros(fes.ndof, dtype=real_t(dtype))
    gf, db = _bdr_geom(fes, nq1d, str(real_t(dtype)))
    fq = eval_coeff(coeff, gf, dtype)
    q = gf.wdet if fq is None else gf.wdet * fq
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        mask = jnp.asarray(sel.astype(np.float64), dtype=real_t(dtype))
        q = q * mask[:, None]
    b_e = eval_values_t(db, q)
    return bdr_restriction_for(fes).mult_transpose(b_e)


def domain_lf_grad(fes, vec, nq1d: Optional[int] = None,
                   dtype=None) -> jnp.ndarray:
    """(f, ∇v) for a vector coefficient f → L-vector
    (DomainLFGradIntegrator, lininteg.hpp:151).

    ∫ f·∇v = Σ_q w ĝᵀ (adj(J) pullback of f) — validated against the
    diffusion operator identity (f = ∇u ⇒ (f,∇v) = a(u,v))."""
    from ..fem.geom_factors import adjugate

    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    rt = real_t(dtype)
    if callable(vec):
        fq = jnp.asarray(vec(gf.x), rt)                  # (ne, nq, sdim)
    else:
        arr = jnp.asarray(vec, rt)
        ne, nq = gf.det.shape
        fq = jnp.broadcast_to(arr[None, None, :], (ne, nq, arr.shape[0]))
    A = adjugate(gf.jac)                                 # J⁻¹ det
    # (J⁻¹ f)·ĝ scaled by w·det /det → q[e,q,d] = w · Σ_s adj[d,s] f_s
    q = jnp.einsum("eqds,eqs->eqd", jnp.swapaxes(A, -1, -2),
                   fq) * jnp.asarray(gf.w, rt)[None, :, None]
    b_e = eval_grad_t(db, q)
    return restriction_for(fes).mult_transpose(b_e)


def _outward_unit_normals(mesh, gf) -> np.ndarray:
    """(nbe, nq, sdim) outward unit normals at boundary quadrature points.

    Sign fixed by dotting against (face point − adjacent element centroid);
    host-side setup path."""
    J = np.asarray(gf.jac)                               # (nbe, nq, sdim, dim-1)
    if mesh.dim == 3:
        n = np.cross(J[..., 0], J[..., 1])               # area-weighted
    else:
        t = J[..., 0]
        n = np.stack([t[..., 1], -t[..., 0]], axis=-1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    vmap = {}
    for e in range(mesh.ne):
        for v in mesh.elements[e]:
            vmap.setdefault(int(v), e)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    for f in range(mesh.nbe):
        e = vmap[int(mesh.boundary[f, 0])]
        # find an element containing ALL face vertices
        cand = [vmap.get(int(v)) for v in mesh.boundary[f]]
        es = set(c for c in cand if c is not None)
        for c in sorted(es):
            if set(int(v) for v in mesh.boundary[f]).issubset(
                set(int(v) for v in mesh.elements[c])
            ):
                e = c
                break
        out = np.asarray(gf.x[f]).mean(axis=0) - cent[e]
        if np.dot(n[f].mean(axis=0), out) < 0:
            n[f] = -n[f]
    return n


def boundary_normal_lf(
    fes, vec, bdr_marker=None, nq1d: Optional[int] = None, dtype=None
) -> jnp.ndarray:
    """∮ (f·n) v over marked boundary faces with the *outward* unit normal
    (BoundaryNormalLFIntegrator, lininteg.hpp:224)."""
    mesh = fes.mesh
    rt = real_t(dtype)
    if mesh.nbe == 0:
        return jnp.zeros(fes.ndof, dtype=rt)
    gf, db = _bdr_geom(fes, nq1d, str(rt))
    n = _outward_unit_normals(mesh, gf)
    if callable(vec):
        fq = np.asarray(vec(np.asarray(gf.x)))           # (nbe, nq, sdim)
    else:
        fq = np.broadcast_to(np.asarray(vec), n.shape)
    q = jnp.asarray((fq * n).sum(axis=-1), rt) * gf.wdet
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        q = q * jnp.asarray(sel.astype(float), rt)[:, None]
    b_e = eval_values_t(db, q)
    return bdr_restriction_for(fes).mult_transpose(b_e)


def vector_boundary_flux_lf(
    fes, coeff, bdr_marker=None, nq1d: Optional[int] = None, dtype=None,
    vdim: Optional[int] = None,
) -> jnp.ndarray:
    """∮ f (v·n) over marked boundary faces for a vdim-valued H1 test space
    (VectorBoundaryFluxLFIntegrator, lininteg.hpp:443) — the natural-traction
    RHS of elasticity under pressure loads.  ``coeff`` is scalar (value or
    callable).  Returns (ndof_scalar · vdim,) in byNODES ordering."""
    mesh = fes.mesh
    rt = real_t(dtype)
    vdim = vdim or getattr(fes, "vdim", mesh.sdim) or mesh.sdim
    nds = fes.ndof_scalar
    if mesh.nbe == 0:
        return jnp.zeros(nds * vdim, dtype=rt)
    gf, db = _bdr_geom(fes, nq1d, str(rt))
    n = _outward_unit_normals(mesh, gf)                  # (nbe, nq, sdim)
    if callable(coeff):
        fq = np.asarray(coeff(np.asarray(gf.x)))         # (nbe, nq)
    else:
        fq = np.broadcast_to(float(coeff), n.shape[:2])
    sel = 1.0
    if bdr_marker is not None:
        sel = np.isin(
            mesh.bdr_attributes, np.asarray(list(bdr_marker))
        ).astype(float)[:, None]
    w = jnp.asarray(fq * sel, rt) * gf.wdet              # (nbe, nq)
    restr = bdr_restriction_for(fes)
    comps = []
    for c in range(vdim):
        q = w * jnp.asarray(n[..., c], rt)
        comps.append(restr.mult_transpose(eval_values_t(db, q)))
    return jnp.concatenate(comps)


def boundary_tangential_lf(
    fes, vec, bdr_marker=None, nq1d: Optional[int] = None, dtype=None
) -> jnp.ndarray:
    """∮ (g·τ) v along the boundary of a 2D mesh, τ the (non-normalized)
    boundary-parametrization tangent — the Jacobian column carries the arc
    measure, so the quadrature weight is ``w`` alone
    (BoundaryTangentialLFIntegrator, lininteg.hpp:248, impl lininteg.cpp:242)."""
    mesh = fes.mesh
    rt = real_t(dtype)
    if mesh.dim != 2:
        raise ValueError("BoundaryTangentialLF makes sense only in 2D")
    if mesh.nbe == 0:
        return jnp.zeros(fes.ndof, dtype=rt)
    gf, db = _bdr_geom(fes, nq1d, str(rt))
    tang = gf.jac[..., 0]                                # (nbe, nq, 2)
    if callable(vec):
        fq = jnp.asarray(vec(gf.x), rt)                  # (nbe, nq, 2)
    else:
        fq = jnp.broadcast_to(jnp.asarray(vec, rt), tang.shape)
    q = (fq * tang).sum(-1) * jnp.asarray(gf.w, rt)[None, :]
    if bdr_marker is not None:
        sel = np.isin(mesh.bdr_attributes, np.asarray(list(bdr_marker)))
        q = q * jnp.asarray(sel.astype(float), rt)[:, None]
    b_e = eval_values_t(db, q)
    return bdr_restriction_for(fes).mult_transpose(b_e)


def vector_quadrature_lf(fes, fq, nq1d: Optional[int] = None,
                         dtype=None) -> jnp.ndarray:
    """(f, v) with f given as an (ne, nq, vdim) Q-vector → byNODES flat
    vector (VectorQuadratureLFIntegrator, lininteg.hpp:761).  The scalar
    version is ``domain_lf_from_qvec`` (QuadratureLFIntegrator, :793)."""
    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    fq = jnp.asarray(fq, real_t(dtype))
    b_e = eval_values_t(db, gf.wdet[..., None] * fq)     # (ne, nd, vdim)
    b = restriction_for(fes).mult_transpose(b_e)         # (ndof, vdim)
    return b.T.reshape(-1)


def white_noise_lf(fes, key, num: Optional[int] = None,
                   nq1d: Optional[int] = None, dtype=None) -> jnp.ndarray:
    """Gaussian random RHS b ~ N(0, M): b = Rᵀ diag(L_e) w with
    L_e L_eᵀ = M_e the element mass Cholesky and w ~ N(0, I) — so
    E[b bᵀ] = Rᵀ diag(M_e) R = M exactly
    (WhiteGaussianNoiseDomainLFIntegrator, lininteg.hpp:664, impl
    lininteg.cpp:1059; the spde-miniapp sampling RHS).

    Design: one batched (ne, nd, nd) Cholesky + one batched matvec —
    the per-element factor loop disappears into ``jnp.linalg.cholesky``.
    ``key`` is a ``jax.random`` key (or an int seed).  ``num=None`` draws
    one sample (ndof,); ``num=k`` draws k i.i.d. samples → (k, ndof)."""
    import jax

    gf = geom_factors_for(fes, nq1d, dtype)
    rt = real_t(dtype)
    B = jnp.asarray(fes.dof_to_quad(nq1d).full_B())      # (nq, nd)
    # element mass matrices M_e = Bᵀ diag(wdet_e) B, batched over elements
    Me = jnp.einsum("qi,eq,qj->eij", B, gf.wdet, B)
    # f64 Cholesky: at f32 the near-singular high-order mass blocks lose PD
    L = jnp.linalg.cholesky(Me.astype(jnp.float64))
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    ne, nd = Me.shape[0], Me.shape[1]
    w = jax.random.normal(key, (ne, nd, num or 1), dtype=jnp.float64)
    b_e = jnp.einsum("eij,ejs->eis", L, w).astype(rt)    # (ne, nd, num)
    b = restriction_for(fes).mult_transpose(b_e)         # (ndof, num)
    return b[:, 0] if num is None else b.T


def delta_lf(fes, points, strengths=None, dtype=None) -> jnp.ndarray:
    """Point (Dirac delta) sources: b_i = Σ_k s_k φ_i(x_k)
    (DeltaCoefficient / VectorDeltaCoefficient RHS, fem/coefficient.hpp:483,
    as used by ex34's delta loads).  Points outside the mesh contribute
    nothing."""
    from ..fem.faces import _eval_volume_basis
    from ..mesh.point_eval import locate_points
    from ..utils.config import real_t

    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    s = (np.ones(len(pts)) if strengths is None
         else np.broadcast_to(np.asarray(strengths, np.float64), (len(pts),)))
    elem, ref = locate_points(fes.mesh, pts)
    b = np.zeros(fes.ndof_scalar)
    found = elem >= 0
    if found.any():
        B = _eval_volume_basis(fes.mesh.geom, fes.order, ref[found])
        np.add.at(b, fes.gather_map[elem[found]].reshape(-1),
                  (B * s[found, None]).reshape(-1))
    return jnp.asarray(b, real_t(dtype))
