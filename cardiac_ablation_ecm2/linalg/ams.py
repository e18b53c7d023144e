"""Auxiliary-space preconditioners for H(curl) and H(div) solves.

Reference analogs: ``HypreAMS`` (``linalg/hypre.hpp:1984``) and ``HypreADS``
(``linalg/hypre.hpp:2061``) — hypre's algebraic Maxwell/divergence solvers,
the reference's answer to the fact that Jacobi-CG on curl-curl / div-div
systems degrades unboundedly under mesh refinement (the operators have huge
near-null spaces: gradients resp. curls).

Design (Hiptmair–Xu auxiliary-space decomposition): instead of
wrapping an algebraic AMG we build the preconditioner from de Rham
transfers the framework already owns and geometric multigrid on scalar H1
spaces (``linalg/multigrid.py``):

  AMS, A = curl curl(α) + mass(β) on ND₁:
      B r = S r + G B_∇(Gᵀ r) + Σ_d Π_d B_Π(Π_dᵀ r)
  with G the discrete gradient (H1→ND, ``ops.vecfe.discrete_gradient``),
  Π the Nédélec interpolation of vertex-vector fields (edge-midpoint rule,
  the AMS "Pi matrix"), S a point smoother, and B_∇ / B_Π scalar-H1
  V-cycles on the exact gradient-space operator Gᵀ A G = β-weighted H1
  stiffness resp. a spectrally equivalent (α∇,∇)+(β·,·) H1 operator per
  component.  All transfers are jit-safe linear maps; adjoints come from
  ``jax.linear_transpose``.

  ADS, A = div div(α) + mass(β) on RT₁:
      B r = S r + C B_AMS(Cᵀ r) + Σ_d Π_d B_Π(Π_dᵀ r)
  with C the discrete curl (ND→RT, exact: Cᵀ A C = β (curl·, curl·) whose
  preconditioner is an AMS cycle with (α,β) → (β, 0⁺)), and Π the RT
  interpolation of vertex-vector fields (face-centroid rule).

Everything is SPD by construction (sum of SPD terms), so the result is a
valid PCG preconditioner; essential (tangential/normal) BCs are handled by
masking ND/RT dofs and imposing matching H1 Dirichlet masks on the
auxiliary spaces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t, real_t


def _h1_vertex_coords(mesh):
    return mesh.vertices


def _mask_from(ess, n, dtype):
    m = np.ones(n, dtype=np.float64)
    if ess is not None and len(ess):
        m[np.asarray(ess)] = 0.0
    return jnp.asarray(m, dtype)


def _nd_pi(mesh, h1_fes, dtype):
    """Π_d apply: scalar H1₁ field w → ND₁ edge dofs of the vector field
    w·ê_d, edge-midpoint rule: dof_e = ½(w_a + w_b)(b−a)_d.

    Exact for the constant fields that carry the HX decomposition (the
    interpolation of a constant vector is reproduced exactly)."""
    from ..mesh.mesh import unique_edges
    from ..ops.vecfe import _vertex_dof_map

    edges, _ = unique_edges(mesh)
    vmap = _vertex_dof_map(h1_fes)
    a = jnp.asarray(vmap[edges[:, 0]], index_t())
    b = jnp.asarray(vmap[edges[:, 1]], index_t())
    tang = jnp.asarray(
        mesh.vertices[edges[:, 1]] - mesh.vertices[edges[:, 0]], dtype
    )                                                   # (nedge, sdim)

    def pi(w, d):
        return 0.5 * (w[a] + w[b]) * tang[:, d]

    return pi


def _rt_pi(mesh, rt_space, h1_fes, dtype):
    """Π_d apply for RT₁: scalar H1₁ field w → face dofs of w·ê_d,
    face-centroid rule: dof_f = mean(w over face verts) · (area·n)_d with
    the face's canonical orientation (matching the space's sign
    convention)."""
    from ..mesh.mesh import unique_faces, unique_edges

    if mesh.dim == 2:
        edges, _ = unique_edges(mesh)
        V = mesh.vertices
        t = V[edges[:, 1]] - V[edges[:, 0]]            # min→max tangent
        n_canon = np.stack([t[:, 1], -t[:, 0]], axis=1)
        verts = edges
    else:
        faces, elem_face = unique_faces(mesh)
        V = mesh.vertices
        if faces.shape[1] == 3:
            # sorted triple IS the canonical frame (fe_vector.py RTSpace)
            n_canon = 0.5 * np.cross(
                V[faces[:, 1]] - V[faces[:, 0]], V[faces[:, 2]] - V[faces[:, 0]]
            )
        else:
            # quad faces: canonical min-vertex cyclic frame, reconstructed
            # from the element-local cyclic tuples (sorted unique_faces rows
            # scramble cyclic order); true area vector = ½ (d13 × d24)
            from ..fem.geometry import FACES

            n_canon = np.zeros((len(faces), 3))
            elems = mesh.elements
            ne = elems.shape[0]
            ar = np.arange(ne)
            for lf, fverts in enumerate(FACES[mesh.geom]):
                gf = elems[:, list(fverts)]             # (ne, 4) cyclic
                r = np.argmin(gf, axis=1)
                nxt = gf[ar, (r + 1) % 4]
                prv = gf[ar, (r - 1) % 4]
                d = np.where(nxt < prv, 1, -1)
                g0 = gf[ar, r]
                g1 = gf[ar, (r + d) % 4]
                g2 = gf[ar, (r + 2 * d) % 4]
                g3 = gf[ar, (r - d) % 4]
                av = 0.5 * np.cross(V[g2] - V[g0], V[g3] - V[g1])
                n_canon[elem_face[:, lf]] = av
        verts = faces
    from ..ops.vecfe import _vertex_dof_map

    nrm = jnp.asarray(n_canon, dtype)
    vmap = _vertex_dof_map(h1_fes)
    vids = jnp.asarray(vmap[verts], index_t())
    inv_nv = 1.0 / verts.shape[1]

    def pi(w, d):
        return w[vids].sum(axis=1) * inv_nv * nrm[:, d]

    return pi


def _transpose_of(fn, n_in, dtype):
    ex = jnp.zeros(n_in, dtype)
    t = jax.linear_transpose(fn, ex)

    def fT(y):
        (x,) = t(y)
        return x

    return fT


@dataclasses.dataclass(eq=False)
class AMSPreconditioner:
    """Callable preconditioner r → B r (use as ``M=`` in ``cg``)."""

    apply_fn: Callable

    def __call__(self, r):
        return self.apply_fn(r)


def _h1_mg_solver(h1_fes, meshes, diff_coeff, mass_coeff, ess_bdr,
                  cheb_order, dtype):
    """Approximate solver for (diff∇u,∇v)+(mass u,v) on H1₁: h-MG V-cycle
    over ``meshes`` (coarse→fine, last = h1_fes.mesh) when given, else a
    Chebyshev sweep (not h-robust — for smoke tests only)."""
    from ..fem.fespace import FESpace
    from ..ops import BilinearForm
    from .multigrid import make_h_multigrid
    from .smoothers import chebyshev

    def op_factory(f):
        a = BilinearForm(f).add_domain_integrator("diffusion",
                                                  coeff=diff_coeff)
        if mass_coeff:
            a.add_domain_integrator("mass", coeff=mass_coeff)
        A = a.assemble(dtype=dtype)
        ess = f.essential_dofs(ess_bdr) if ess_bdr else np.zeros(0, np.int32)
        m = _mask_from(ess, f.ndof_scalar, real_t(dtype))

        class _Op:
            def mult(self, v):
                return A.mult(v * m) * m + (v - v * m)

            def diagonal(self):
                return A.diagonal() * m + (1 - m)

        return _Op()

    if meshes is not None:
        mg = make_h_multigrid(
            meshes, lambda mm: FESpace(mm, 1), op_factory,
            smoother_order=cheb_order,
            ess_factory=(lambda f: f.essential_dofs(ess_bdr))
            if ess_bdr else None,
            dtype=dtype,
        )
        return mg.preconditioner()
    op = op_factory(h1_fes)
    return chebyshev(op.mult, op.diagonal(), order=cheb_order)


def make_ams(
    nd_space,
    h1_fes,
    A_mult: Callable,
    A_diag: jnp.ndarray,
    *,
    alpha=1.0,
    beta=1.0,
    ess_bdr: Optional[Sequence[int]] = None,
    meshes: Optional[Sequence] = None,
    cheb_order: int = 3,
    dtype=None,
) -> AMSPreconditioner:
    """AMS preconditioner for ``A = curlcurl(α) + mass(β)`` on ND₁.

    ``A_mult``/``A_diag`` — the (already essential-constrained) operator and
    its diagonal.  ``meshes`` — uniform-refinement hierarchy ending at
    ``nd_space.mesh`` for the auxiliary H1 V-cycles (without it the
    auxiliary solves degrade to Chebyshev sweeps).  β may be 0 (singular
    mass-free curl-curl is still preconditioned; pair with a rank-fixing
    rel_tol or a tiny mass shift in A itself).
    """
    from ..ops.vecfe import discrete_gradient

    rt = real_t(dtype)
    mesh = nd_space.mesh
    dim = mesh.dim

    ess_nd = nd_space.essential_dofs(ess_bdr) if ess_bdr else None
    m_nd = _mask_from(ess_nd, nd_space.ndof, rt)
    ess_h1 = h1_fes.essential_dofs(ess_bdr) if ess_bdr else None
    m_h1 = _mask_from(ess_h1, h1_fes.ndof_scalar, rt)

    G0 = discrete_gradient(h1_fes, nd_space)
    pi0 = _nd_pi(mesh, h1_fes, rt)

    def G(u):
        return G0(u * m_h1) * m_nd

    GT = _transpose_of(G, h1_fes.ndof_scalar, rt)

    pis, piTs = [], []
    for d in range(dim):
        def pid(w, d=d):
            return pi0(w * m_h1, d) * m_nd

        pis.append(pid)
        piTs.append(_transpose_of(pid, h1_fes.ndof_scalar, rt))

    # exact gradient-space operator: Gᵀ(curlcurl_α + mass_β)G = β-H1 stiffness
    bgrad = _h1_mg_solver(h1_fes, meshes, beta if beta else 1.0, 0.0,
                          ess_bdr, cheb_order, dtype)
    # Πᵀ A Π per component ≈ (α∇,∇) + (β·,·) scalar H1
    bpi = _h1_mg_solver(h1_fes, meshes, alpha, beta, ess_bdr,
                        cheb_order, dtype)

    inv_diag = jnp.where(A_diag > 0, 1.0 / A_diag, 1.0)

    def apply_fn(r):
        x = inv_diag * r                      # point smoother
        x = x + G(bgrad(GT(r)))
        for d in range(dim):
            x = x + pis[d](bpi(piTs[d](r)))
        return x

    return AMSPreconditioner(apply_fn)


def make_ads(
    rt_space,
    nd_space,
    h1_fes,
    A_mult: Callable,
    A_diag: jnp.ndarray,
    *,
    alpha=1.0,
    beta=1.0,
    ess_bdr: Optional[Sequence[int]] = None,
    meshes: Optional[Sequence] = None,
    cheb_order: int = 3,
    dtype=None,
) -> AMSPreconditioner:
    """ADS preconditioner for ``A = divdiv(α) + mass(β)`` on RT₁ (3D; in 2D
    the rotation identity makes H(div) ≡ rotated H(curl) and the Π/G terms
    below already cover it without the curl sweep)."""
    from ..ops.vecfe import discrete_curl

    rt = real_t(dtype)
    mesh = rt_space.mesh
    dim = mesh.dim

    ess_rt = rt_space.essential_dofs(ess_bdr) if ess_bdr else None
    m_rt = _mask_from(ess_rt, rt_space.ndof, rt)
    pi0 = _rt_pi(mesh, rt_space, h1_fes, rt)
    ess_h1 = h1_fes.essential_dofs(ess_bdr) if ess_bdr else None
    m_h1 = _mask_from(ess_h1, h1_fes.ndof_scalar, rt)

    pis, piTs = [], []
    for d in range(dim):
        def pid(w, d=d):
            return pi0(w * m_h1, d) * m_rt

        pis.append(pid)
        piTs.append(_transpose_of(pid, h1_fes.ndof_scalar, rt))

    # Πᵀ A Π ≈ (α∇,∇)+(β·,·) scalar H1 per component
    bpi = _h1_mg_solver(h1_fes, meshes, alpha, beta, ess_bdr,
                        cheb_order, dtype)

    curl_sweep = None
    if dim == 3 and nd_space is not None:
        C0 = discrete_curl(nd_space, rt_space)
        ess_nd = nd_space.essential_dofs(ess_bdr) if ess_bdr else None
        m_nd = _mask_from(ess_nd, nd_space.ndof, rt)

        def C(e):
            return C0(e * m_nd) * m_rt

        CT = _transpose_of(C, nd_space.ndof, rt)
        # Cᵀ A C = β (curl·,curl·) on ND — precondition with an AMS cycle
        # whose curl weight is β; the mass weight is a small regularization
        # (the curl operator's gradient kernel is handled inside AMS).
        bshift = (beta if beta else 1.0) * 1e-2

        def CtAC(e):
            return CT(A_mult(C(e)))

        # diagonal of CᵀAC via probing is overkill: use an AMS cycle built
        # on its own ND curlcurl operator instead
        from ..ops.vecfe import build_nd_operator

        nd_op = build_nd_operator(
            nd_space, mass_coeff=bshift,
            curlcurl_coeff=(beta if beta else 1.0), dtype=dtype)
        nd_diag = nd_op.diagonal() * m_nd + (1 - m_nd)

        def nd_mult(e):
            return nd_op.mult(e * m_nd) * m_nd + (e - e * m_nd)

        ams_inner = make_ams(
            nd_space, h1_fes, nd_mult, nd_diag,
            alpha=(beta if beta else 1.0), beta=bshift, ess_bdr=ess_bdr,
            meshes=meshes, cheb_order=cheb_order, dtype=dtype,
        )

        def curl_sweep(r):                               # noqa: F811
            return C(ams_inner(CT(r)))

    inv_diag = jnp.where(A_diag > 0, 1.0 / A_diag, 1.0)

    def apply_fn(r):
        x = inv_diag * r
        for d in range(dim):
            x = x + pis[d](bpi(piTs[d](r)))
        if curl_sweep is not None:
            x = x + curl_sweep(r)
        return x

    return AMSPreconditioner(apply_fn)
