"""Sharded H(curl)/H(div) solves — the ex3p/ex4p capability slice.

Reference analog: ``examples/ex3p.cpp`` / ``ex4p.cpp``: ParMesh +
ND/RT ``ParFiniteElementSpace`` + parallel PA apply + PCG (SURVEY.md §2.5).
Design: the *canonical* dof numbering makes vector spaces shard exactly
like H1 — canonical dof values are orientation-independent, so the halo
exchange is the same symmetric partial-sum ppermute schedule; per-element
orientation (±1 signs or true DofTransformations) is applied inside the
device-local gather/scatter, never across devices.  One ``shard_map``
region holds the whole CG solve with psum inner products.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..linalg.solvers import cg
from ..ops.mixed_vecfe import _kind
from ..ops.vecfe import build_nd_operator, build_rt_operator, \
    vecfe_linear_form
from ..utils.config import real_t
from . import ops as pops
from .pfespace import build, gather_global, scatter_global
from .poisson import _stack_local_ess


def _make_inshard_ams(stat, arrs, sg_l, perms_nd, *, g_nd, pm_nd, seg_nd,
                      send_nd, nloc_nd, emask_nd, dg_nd):
    """In-shard AMS preconditioner closure (runs inside the solve's
    shard_map region).  All transfers are element-mediated: per-element
    values → local scatter → ppermute halo sum → ×(1/global multiplicity);
    auxiliary H1 solves are Chebyshev sweeps on dense order-1 element
    matrices (eigenvalue bounds estimated host-side at setup)."""
    from ..linalg.smoothers import chebyshev

    (g_h1, pm_h1, seg_h1, send_h1, ess_h1, dgg, dgp,
     Aeg, Aep, tv, minv, ew) = arrs
    nloc_h1 = stat["nloc_h1"]
    perms_h1 = stat["perms_h1"]
    ua, ub, dim = stat["ua"], stat["ub"], stat["dim"]
    em_h1 = jnp.ones(nloc_h1 + 1, dgg.dtype).at[ess_h1].set(0.0)
    minv_m = minv * emask_nd

    def _h1_collect(y_e):
        y = pops.local_scatter(y_e, pm_h1, seg_h1, nloc_h1)
        return pops.halo_sum(y, send_h1, perms_h1, nloc_h1) * em_h1

    def _nd_collect(val):
        y = pops.local_scatter(val, pm_nd, seg_nd, nloc_nd)
        return minv_m * pops.halo_sum(y, send_nd, perms_nd, nloc_nd)

    def h1_op(Ae):
        def A(w):
            z = w * em_h1
            y_e = jnp.einsum("enm,em->en", Ae, z[g_h1])
            y = pops.local_scatter(y_e, pm_h1, seg_h1, nloc_h1)
            y = pops.halo_sum(y, send_h1, perms_h1, nloc_h1)
            return y * em_h1 + (w - z)

        return A

    def G(u):
        e = (u * em_h1)[g_h1]
        return _nd_collect(sg_l * (e[:, ub] - e[:, ua]) * ew)

    def GT(y):
        z = (minv_m * y)[g_nd] * sg_l * ew
        w_e = jnp.zeros(g_h1.shape, z.dtype)
        w_e = w_e.at[:, ub].add(z).at[:, ua].add(-z)
        return _h1_collect(w_e)

    def Pi(w, d):
        e = (w * em_h1)[g_h1]
        return _nd_collect(0.5 * (e[:, ua] + e[:, ub]) * tv[:, :, d] * ew)

    def PiT(y, d):
        z = 0.5 * (minv_m * y)[g_nd] * tv[:, :, d] * ew
        w_e = jnp.zeros(g_h1.shape, z.dtype)
        w_e = w_e.at[:, ua].add(z).at[:, ub].add(z)
        return _h1_collect(w_e)

    cheb_g = chebyshev(h1_op(Aeg), dgg, order=3, eig_max=stat["lmax_grad"])
    cheb_p = chebyshev(h1_op(Aep), dgp, order=3, eig_max=stat["lmax_pi"])

    def M(r):
        x = r / dg_nd
        x = x + G(cheb_g(GT(r)))
        for d in range(dim):
            x = x + Pi(cheb_p(PiT(r, d)), d)
        return x

    return M


class _Shim:
    """Duck-typed FESpace view of a vector space for ``pfespace.build``
    (canonical gather_map + mesh are all it needs)."""

    def __init__(self, space):
        self.mesh = space.mesh
        self.gather_map = np.asarray(space.gather_map)
        self.ndof_scalar = space.ndof
        self.order = 1                       # geometry nodes


@dataclasses.dataclass(eq=False)
class ParVecFE:
    pf: object
    dmesh: DeviceMesh
    solve_fn: Callable

    def solve(self):
        x_loc, iters, final = self.solve_fn()
        u = gather_global(self.pf, np.asarray(x_loc))
        return u[: self.pf.ndof_global], int(iters), float(final)


def _ams_tables(space, mesh, pf, ndev, mass_coeff, curlcurl_coeff, ess_bdr,
                rt):
    """Host-side stacked tables for the in-shard AMS preconditioner
    (linalg/ams.py, sharded): element-mediated discrete-gradient / Π
    transfers (every transfer = per-element values → local scatter → halo
    sum → 1/multiplicity), dense order-1 H1 element matrices for the two
    auxiliary operators, and host-estimated Chebyshev eigenvalue bounds."""
    from ..fem.fespace import FESpace, element_node_coords
    from ..fem.geometry import EDGES
    from ..fem.build import geom_factors_for
    from ..ops import diffusion as diff_mod
    from ..ops import mass as mass_mod
    from ..ops.vecfe import _vertex_dof_map
    from .pfespace import build as pbuild

    alpha = curlcurl_coeff if curlcurl_coeff else 1.0
    beta = mass_coeff if mass_coeff else 1.0
    h1 = FESpace(mesh, 1)
    pf_h1 = pbuild(h1, ndev, parts=pf.parts)

    # local-dof position of each element vertex (lex dof order is a
    # permutation of the vertex order)
    from ..ops.vecfe import vertex_dof_positions

    dofpos = vertex_dof_positions(mesh)
    loc_edges = np.array(EDGES[mesh.geom])
    ua_idx = dofpos[loc_edges[:, 0]]
    ub_idx = dofpos[loc_edges[:, 1]]

    # per-(element, local edge) global min→max tangent vectors
    ev = mesh.elements[:, loc_edges]
    lo = np.minimum(ev[:, :, 0], ev[:, :, 1])
    hi = np.maximum(ev[:, :, 0], ev[:, :, 1])
    tvec = mesh.vertices[hi] - mesh.vertices[lo]       # (ne, nle, dim)

    # 1/(global incidence count) per ND dof, on local slabs
    cnt = np.bincount(np.asarray(space.gather_map).reshape(-1),
                      minlength=space.ndof).astype(np.float64)
    minv = np.zeros((ndev, pf.nloc + 1))
    for d in range(ndev):
        g = pf.loc2glob[d]
        ok = g >= 0
        minv[d, :pf.nloc][ok] = 1.0 / cnt[g[ok]]

    # dense H1 element matrices: grad-aux = β-stiffness; Π-aux = α∇+β mass
    gf = geom_factors_for(h1)
    d2q = h1.dof_to_quad(None)
    B, G = d2q.full_B(), d2q.full_G()
    qd_d = np.asarray(diff_mod.setup(gf))
    qd_m = np.asarray(mass_mod.setup(gf))
    stiff = np.einsum("qma,eqab,qnb->emn", G, qd_d, G)
    massm = np.einsum("qm,eq,qn->emn", B, qd_m, B)
    Ae_grad = beta * stiff
    Ae_pi = alpha * stiff + beta * massm

    def h1_diag(Ae):
        dg = np.zeros(h1.ndof_scalar)
        np.add.at(dg, h1.gather_map.reshape(-1),
                  np.einsum("enn->en", Ae).reshape(-1))
        return dg

    ess_h1 = (h1.essential_dofs(ess_bdr) if ess_bdr is not None
              else np.zeros(0, np.int32))
    mask_h1 = np.ones(h1.ndof_scalar)
    mask_h1[ess_h1] = 0.0

    def lmax_of(Ae):
        """Host power iteration on the masked assembled operator."""
        import scipy.sparse as sp

        gm = h1.gather_map.astype(np.int64)
        ne_, nd_ = gm.shape
        rows = np.repeat(gm, nd_, axis=1).reshape(-1)
        cols = np.tile(gm, (1, nd_)).reshape(-1)
        A = sp.coo_matrix((Ae.reshape(-1), (rows, cols)),
                          shape=(h1.ndof_scalar,) * 2).tocsr()
        dg = h1_diag(Ae) * mask_h1 + (1 - mask_h1)
        v = np.random.default_rng(0).standard_normal(h1.ndof_scalar)
        lam = 1.0
        for _ in range(25):
            v = mask_h1 * (A @ (mask_h1 * v)) / dg
            lam = np.linalg.norm(v)
            v = v / lam
        return float(lam)

    dg_grad = h1_diag(Ae_grad) * mask_h1 + (1 - mask_h1)
    dg_pi = h1_diag(Ae_pi) * mask_h1 + (1 - mask_h1)

    from .pfespace import scatter_global as pscat
    from .poisson import _stack_local_ess as _sle

    stat = dict(
        nloc_h1=pf_h1.nloc, perms_h1=pf_h1.perms,
        ua=ua_idx, ub=ub_idx, dim=mesh.dim,
        lmax_grad=lmax_of(Ae_grad), lmax_pi=lmax_of(Ae_pi),
    )
    arrays = [
        jnp.asarray(pf_h1.gather),                         # g_h1
        jnp.asarray(pf_h1.scat_perm),
        jnp.asarray(pf_h1.scat_seg),
        jnp.asarray(pf_h1.send_idx),
        jnp.asarray(_sle(pf_h1, ess_h1)),
        jnp.asarray(np.where(pscat(pf_h1, dg_grad) == 0.0, 1.0,
                             pscat(pf_h1, dg_grad)), rt),
        jnp.asarray(np.where(pscat(pf_h1, dg_pi) == 0.0, 1.0,
                             pscat(pf_h1, dg_pi)), rt),
        jnp.asarray(Ae_grad[pf.elems] * pf.elem_weight[:, :, None, None], rt),
        jnp.asarray(Ae_pi[pf.elems] * pf.elem_weight[:, :, None, None], rt),
        jnp.asarray(tvec[pf.elems] * pf.elem_weight[:, :, None, None], rt),
        jnp.asarray(minv, rt),
        jnp.asarray(pf.elem_weight[:, :, None], rt),       # ew (bcastable)
    ]
    return stat, arrays


def setup(
    space,
    mass_coeff: Optional[float] = 1.0,
    curlcurl_coeff: Optional[float] = None,
    divdiv_coeff: Optional[float] = None,
    rhs_fn: Callable = None,
    ess_bdr: Optional[Sequence[int]] = None,
    ndev: Optional[int] = None,
    nq1d: int = 3,
    rel_tol: float = 1e-10,
    max_iter: int = 3000,
    dtype=None,
    devices=None,
    precond: str = "jacobi",
) -> ParVecFE:
    """Sharded α(u,v)+β(curl u,curl v) (ND) or α(u,v)+β(div u,div v) (RT)
    solve with (f, v) RHS and homogeneous essential trace BCs.

    ``precond="ams"`` (ND₁ only): in-shard auxiliary-space preconditioner —
    the sharded analog of ``linalg.ams.make_ams`` (HypreAMS,
    linalg/hypre.hpp:1984).  Every AMS transfer is element-mediated so it
    reuses the existing local-scatter + ppermute halo-sum machinery; the
    auxiliary H1 solves are Chebyshev sweeps on dense order-1 element
    matrices with host-estimated eigenvalue bounds."""
    rt = real_t(dtype)
    if devices is None:
        devices = jax.devices()
    if ndev is None:
        ndev = len(devices)

    if _kind(space) == "nd":
        op = build_nd_operator(space, mass_coeff=mass_coeff,
                               curlcurl_coeff=curlcurl_coeff, nq1d=nq1d,
                               dtype=dtype)
    else:
        op = build_rt_operator(space, mass_coeff=mass_coeff,
                               divdiv_coeff=divdiv_coeff, nq1d=nq1d,
                               dtype=dtype)

    pf = build(_Shim(space), ndev)
    dmesh = DeviceMesh(np.array(devices[:ndev]), (pops.AXIS,))

    # per-device stacked tables (padded elements weighted to zero)
    ew = pf.elem_weight                                   # (ndev, ne_loc)
    qds = [jnp.asarray(np.asarray(qd)[pf.elems]
                       * ew[:, :, None], rt) for _, qd, _ in op.terms]
    Bqs = [jnp.asarray(np.asarray(Bq)[pf.elems], rt) for _, _, Bq in
           op.terms]

    # orientation: stacked signs, or stacked DofTransformation codes
    simplex = op.tf is not None
    if simplex:
        dummy = jnp.zeros((ndev, pf.ne_loc, 1), jnp.int32)
        ec = (jnp.asarray(space.edge_code[pf.elems]) if space.nE
              else dummy)
        fc = (jnp.asarray(space.face_code[pf.elems])
              if (space.dim == 3 and space.nF) else dummy)
        eTi, fTi = getattr(space, "_eTi", None), getattr(space, "_fTi",
                                                         None)
        nle, nE = space.nle, space.nE
        nlf, nF = space.nlf, space.nF
        nI = space.nI
    else:
        sgs = jnp.asarray(np.asarray(op.signs)[pf.elems], rt)

    # serial-assembled RHS + diagonal, replicated to device-local slabs
    if rhs_fn is not None:
        b_glob = np.asarray(vecfe_linear_form(op, rhs_fn))
    else:
        b_glob = np.ones(op.ndof)
    d_glob = np.asarray(op.diagonal())
    ess_global = (space.essential_dofs(ess_bdr)
                  if ess_bdr is not None else np.zeros(0, np.int32))
    ess_loc = _stack_local_ess(pf, ess_global)

    bs = jnp.asarray(scatter_global(pf, b_glob), rt)
    ds = jnp.asarray(scatter_global(pf, d_glob), rt)
    gth = jnp.asarray(pf.gather)
    perm = jnp.asarray(pf.scat_perm)
    seg = jnp.asarray(pf.scat_seg)
    send = jnp.asarray(pf.send_idx)
    dw = jnp.asarray(pf.dof_weight, rt)
    essl = jnp.asarray(ess_loc)
    nloc = pf.nloc
    perms = pf.perms

    def _tf(e, codes_e, codes_f):
        """Per-device canonical → reference coefficients (transform)."""
        out, ofs = [], 0
        n = e.shape[0]
        if nE:
            blk = e[:, : nle * nE].reshape(n, nle, nE)
            T = eTi[codes_e]
            out.append(jnp.einsum("nekl,nel->nek", T, blk).reshape(n, -1))
            ofs += nle * nE
        if nF and space.dim == 3:
            blk = e[:, ofs: ofs + nlf * nF].reshape(n, nlf, nF)
            T = fTi[codes_f]
            out.append(jnp.einsum("nekl,nel->nek", T, blk).reshape(n, -1))
            ofs += nlf * nF
        if nI:
            out.append(e[:, ofs:])
        return jnp.concatenate(out, axis=1)

    def _tft(y, codes_e, codes_f):
        out, ofs = [], 0
        n = y.shape[0]
        if nE:
            blk = y[:, : nle * nE].reshape(n, nle, nE)
            T = eTi[codes_e]
            out.append(jnp.einsum("nelk,nel->nek", T, blk).reshape(n, -1))
            ofs += nle * nE
        if nF and space.dim == 3:
            blk = y[:, ofs: ofs + nlf * nF].reshape(n, nlf, nF)
            T = fTi[codes_f]
            out.append(jnp.einsum("nelk,nel->nek", T, blk).reshape(n, -1))
            ofs += nlf * nF
        if nI:
            out.append(y[:, ofs:])
        return jnp.concatenate(out, axis=1)

    ams_stat, ams_arrays = None, []
    if precond == "ams":
        if simplex or _kind(space) != "nd":
            raise NotImplementedError(
                "sharded AMS: lowest-order ND (NDSpace) only")
        ams_stat, ams_arrays = _ams_tables(
            space, space.mesh, pf, ndev, mass_coeff, curlcurl_coeff,
            ess_bdr, rt)

    nterm = len(op.terms)
    spec = P(pops.AXIS)
    n_in = 7 + 2 * nterm + (2 if simplex else 1) + len(ams_arrays)

    @partial(shard_map, mesh=dmesh, in_specs=(spec,) * n_in,
             out_specs=(spec, P(), P()), check_vma=False)
    def _solve(b, dg0, g, pm, sg, sd, w_dof, *rest):
        b, dg0, g, pm, sg = b[0], dg0[0], g[0], pm[0], sg[0]
        sd, w_dof = sd[0], w_dof[0]
        rest = [r[0] for r in rest]
        qd_l = rest[:nterm]
        Bq_l = rest[nterm: 2 * nterm]
        if simplex:
            ce = rest[2 * nterm]
            cf = rest[2 * nterm + 1]

            def pre(e):
                return _tf(e, ce, cf)

            def post(y):
                return _tft(y, ce, cf)
        else:
            sg_l = rest[2 * nterm]

            def pre(e):
                return e * sg_l

            post = pre
        ess = essl[lax.axis_index(pops.AXIS)]
        emask = jnp.ones(nloc + 1, rt).at[ess].set(0.0)

        def A(v):
            z = v * emask
            e = pre(z[g])
            y = jnp.zeros(e.shape, e.dtype)
            for qd, Bq in zip(qd_l, Bq_l):
                q = jnp.einsum("eqnc,en->eqc", Bq, e)
                y = y + jnp.einsum("eqnc,eqc->en", Bq,
                                   qd[..., None] * q)
            y = pops.local_scatter(post(y), pm, sg, nloc)
            y = pops.halo_sum(y, sd, perms, nloc)
            return y * emask + (v - z)

        b = pops.zero_at(b * emask, ess)
        dg = dg0 * emask + (1.0 - emask)
        dg = dg.at[nloc].set(1.0)
        dg = jnp.where(dg == 0.0, 1.0, dg)
        pdot = pops.make_pdot(w_dof)
        if ams_stat is not None:
            M = _make_inshard_ams(
                ams_stat, rest[-len(ams_arrays):], sg_l, perms,
                g_nd=g, pm_nd=pm, seg_nd=sg, send_nd=sd, nloc_nd=nloc,
                emask_nd=emask, dg_nd=dg)
        else:
            M = lambda r: r / dg                        # noqa: E731
        x, info = cg(A, b, M=M, rel_tol=rel_tol,
                     max_iter=max_iter, dot=pdot)
        return x[None], info.iterations, info.final_norm

    args = [bs, ds, gth, perm, seg, send, dw] + qds + Bqs
    if simplex:
        args += [ec, fc]
    else:
        args.append(sgs)
    args += ams_arrays

    def run():
        return jax.jit(_solve)(*args)

    return ParVecFE(pf=pf, dmesh=dmesh, solve_fn=run)
