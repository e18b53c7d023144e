"""Sharded DG advection — ghost-face exchange over the device mesh.

Reference analog: ``ParMesh::ExchangeFaceNbrData`` (``mesh/pmesh.cpp:2079``)
+ ``ParL2FaceRestriction`` (``fem/prestriction.hpp:139``) feeding the ex9p
DG transport loop.

Design: L2 spaces have no shared dofs, so the only communication
is face traces.  Host setup partitions elements (RCB), classifies interior
faces into device-local and cross-device, and builds an edge-colored
ppermute schedule over device pairs (same pattern as the continuous halo in
``pfespace``).  Per RK stage, each device computes its own side's face-trace
values for every cross face, exchanges them with one ``lax.ppermute`` per
color, forms the upwind flux with (own, received) traces, and scatters only
into its own elements.  Traces are *values at face quadrature points*
(nq_f floats per face) — strictly less traffic than exchanging dofs.
"""

from __future__ import annotations

import dataclasses
from functools import partial as fpartial
from typing import Callable, List, Optional, Tuple

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

from ..fem.build import basis_for, geom_factors_for
from ..fem.faces import build_face_data
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad_t, eval_values
from ..ops import mass as mmod
from ..utils.config import index_t, real_t
from . import ops as pops
from .partition import partition_mesh


def _edge_color(pairs: List[Tuple[int, int]]):
    """Greedy edge coloring: each color is a matching of device pairs."""
    colors: List[List[Tuple[int, int]]] = []
    for e in sorted(pairs):
        for cls in colors:
            if all(e[0] not in p and e[1] not in p for p in cls):
                cls.append(e)
                break
        else:
            colors.append([e])
    return colors


@dataclasses.dataclass(eq=False)
class ParDGAdvection:
    """Sharded ex9 operator: u stacked (ndev, ne_loc, nd)."""

    fes: object
    dmesh: DeviceMesh
    parts: np.ndarray
    elems: np.ndarray            # (ndev, ne_loc) global ids (pad -1)
    ne_loc: int
    mult: Callable               # (t, u_stacked (ndev, ne_loc*nd)) -> same

    def scatter(self, u_global: np.ndarray) -> jnp.ndarray:
        """Global (ne*nd,) L2 field → stacked (ndev, ne_loc*nd)."""
        nd = self.fes.nd_elem
        u = np.asarray(u_global).reshape(-1, nd)
        out = np.zeros((self.elems.shape[0], self.ne_loc, nd), u.dtype)
        for d in range(self.elems.shape[0]):
            sel = self.elems[d] >= 0
            out[d, sel] = u[self.elems[d][sel]]
        return jnp.asarray(out.reshape(self.elems.shape[0], -1))

    def gather(self, u_loc) -> np.ndarray:
        nd = self.fes.nd_elem
        u = np.asarray(u_loc).reshape(self.elems.shape[0], self.ne_loc, nd)
        ne = self.fes.mesh.ne
        out = np.zeros((ne, nd), u.dtype)
        for d in range(self.elems.shape[0]):
            sel = self.elems[d] >= 0
            out[self.elems[d][sel]] = u[d, sel]
        return out.reshape(-1)


def setup(
    fes,
    velocity: Callable,
    inflow: Optional[Callable] = None,
    ndev: Optional[int] = None,
    devices=None,
    nq1d: Optional[int] = None,
    dtype=None,
    parts: Optional[np.ndarray] = None,
) -> ParDGAdvection:
    mesh = fes.mesh
    rt = real_t(dtype)
    if devices is None:
        devices = jax.devices()
    if ndev is None:
        ndev = len(devices)
    dmesh = DeviceMesh(np.array(devices[:ndev]), (pops.AXIS,))
    if parts is None:
        parts = partition_mesh(mesh, ndev)

    db = basis_for(fes, nq1d, dtype)
    gf = geom_factors_for(fes, nq1d, dtype)
    nd = fes.nd_elem
    ne = mesh.ne

    # global volume qdata / mass inverse (host), then shard by element
    vq = np.asarray(velocity(np.asarray(gf.x)))
    A = np.asarray(adjugate(gf.jac))
    vol_qd = np.einsum("eqba,eqa->eqb", A, vq) * np.asarray(
        gf.w)[None, :, None]
    d2q = fes.d2q if nq1d is None else fes.dof_to_quad(nq1d)
    B = d2q.full_B()
    qd = np.asarray(mmod.setup(gf))
    Me = np.einsum("qm,eq,qn->emn", B, qd, B)
    Minv = np.linalg.inv(Me)

    dev_elems = [np.nonzero(parts == d)[0] for d in range(ndev)]
    ne_loc = max(len(e) for e in dev_elems)
    elems = np.full((ndev, ne_loc), -1, dtype=np.int64)
    g2l = np.full(ne, -1, dtype=np.int64)
    for d, e in enumerate(dev_elems):
        elems[d, : len(e)] = e
        g2l[e] = np.arange(len(e))

    def stack_elem(arrg, fill=0.0):
        out = np.full((ndev, ne_loc) + arrg.shape[1:], fill, arrg.dtype)
        for d, e in enumerate(dev_elems):
            out[d, : len(e)] = arrg[e]
        return out

    vol_s = jnp.asarray(stack_elem(vol_qd.astype(np.float64)), rt)
    minv_s = jnp.asarray(stack_elem(Minv.astype(np.float64)), rt)

    # ---------------- face classification --------------------------------
    fd = build_face_data(mesh, fes.order, nq1d)
    nqf = fd.B0.shape[1]
    vn = np.einsum("fqd,fqd->fq", np.asarray(velocity(fd.xq)), fd.normal)
    vnw = vn * fd.wdet                                  # (nfi, nq_f)

    d0 = parts[fd.elem0]
    d1 = parts[fd.elem1]
    local = d0 == d1
    cross = ~local

    # local interior faces, stacked per device
    nfl = max(
        (int(np.sum(local & (d0 == d))) for d in range(ndev)), default=0
    )
    nfl = max(nfl, 1)
    e0l = np.zeros((ndev, nfl), np.int64)
    e1l = np.zeros((ndev, nfl), np.int64)
    B0l = np.zeros((ndev, nfl) + fd.B0.shape[1:], fd.B0.dtype)
    B1l = np.zeros_like(B0l)
    vnl = np.zeros((ndev, nfl, nqf), vnw.dtype)
    for d in range(ndev):
        sel = np.nonzero(local & (d0 == d))[0]
        e0l[d, : len(sel)] = g2l[fd.elem0[sel]]
        e1l[d, : len(sel)] = g2l[fd.elem1[sel]]
        B0l[d, : len(sel)] = fd.B0[sel]
        B1l[d, : len(sel)] = fd.B1[sel]
        vnl[d, : len(sel)] = vnw[sel]

    # cross faces: edge-colored pair schedule
    cross_idx = np.nonzero(cross)[0]
    pairs = sorted({
        (min(d0[f], d1[f]), max(d0[f], d1[f])) for f in cross_idx
    })
    colors = _edge_color(list(pairs))
    ncolors = len(colors)
    pair_color = {}
    for c, cls in enumerate(colors):
        for pr in cls:
            pair_color[pr] = c

    # per (device, color): list of cross faces, ordered by global face index
    face_lists = [[[] for _ in range(ncolors)] for _ in range(ndev)]
    for f in cross_idx:
        pr = (min(d0[f], d1[f]), max(d0[f], d1[f]))
        c = pair_color[pr]
        face_lists[d0[f]][c].append((f, 0))
        face_lists[d1[f]][c].append((f, 1))
    nfc = max(
        (len(fl) for dev in face_lists for fl in dev), default=0
    )
    nfc = max(nfc, 1)

    ecx = np.zeros((ndev, ncolors, nfc), np.int64)       # own elem (local)
    Bcx = np.zeros((ndev, ncolors, nfc) + fd.B0.shape[1:], fd.B0.dtype)
    vncx = np.zeros((ndev, ncolors, nfc, nqf), vnw.dtype)
    rolex = np.zeros((ndev, ncolors, nfc), bool)         # True = side 0
    for d in range(ndev):
        for c in range(ncolors):
            fl = sorted(face_lists[d][c])                # by global face id
            for i, (f, side) in enumerate(fl):
                if side == 0:
                    ecx[d, c, i] = g2l[fd.elem0[f]]
                    Bcx[d, c, i] = fd.B0[f]
                else:
                    ecx[d, c, i] = g2l[fd.elem1[f]]
                    Bcx[d, c, i] = fd.B1[f]
                vncx[d, c, i] = vnw[f]
                rolex[d, c, i] = side == 0

    perms = []
    for cls in colors:
        pr = []
        for a, b in cls:
            pr.append((a, b))
            pr.append((b, a))
        perms.append(tuple(pr))
    perms = tuple(perms)

    # boundary faces per device
    bd = parts[fd.b_elem]
    bvn = np.einsum(
        "fqd,fqd->fq", np.asarray(velocity(fd.b_xq)), fd.b_normal
    ) * fd.b_wdet
    g_in = (np.asarray(inflow(fd.b_xq)) if inflow is not None
            else np.zeros_like(bvn))
    nfb = max((int(np.sum(bd == d)) for d in range(ndev)), default=0)
    nfb = max(nfb, 1)
    bel = np.zeros((ndev, nfb), np.int64)
    bBl = np.zeros((ndev, nfb) + fd.b_B.shape[1:], fd.b_B.dtype)
    bvnl = np.zeros((ndev, nfb, nqf), bvn.dtype)
    ginl = np.zeros((ndev, nfb, nqf), bvn.dtype)
    for d in range(ndev):
        sel = np.nonzero(bd == d)[0]
        bel[d, : len(sel)] = g2l[fd.b_elem[sel]]
        bBl[d, : len(sel)] = fd.b_B[sel]
        bvnl[d, : len(sel)] = bvn[sel]
        ginl[d, : len(sel)] = g_in[sel]

    to_dev = lambda a: jnp.asarray(a.astype(np.float64), rt) if (
        a.dtype.kind == "f") else jnp.asarray(a)
    e0l_j, e1l_j = jnp.asarray(e0l, index_t()), jnp.asarray(e1l, index_t())
    B0l_j, B1l_j, vnl_j = to_dev(B0l), to_dev(B1l), to_dev(vnl)
    ecx_j = jnp.asarray(ecx, index_t())
    Bcx_j, vncx_j = to_dev(Bcx), to_dev(vncx)
    rolex_j = jnp.asarray(rolex)
    bel_j = jnp.asarray(bel, index_t())
    bBl_j, bvnl_j, ginl_j = to_dev(bBl), to_dev(bvnl), to_dev(ginl)

    spec = P(pops.AXIS)
    args = (vol_s, minv_s, e0l_j, e1l_j, B0l_j, B1l_j, vnl_j,
            ecx_j, Bcx_j, vncx_j, rolex_j, bel_j, bBl_j, bvnl_j, ginl_j)

    @fpartial(
        shard_map, mesh=dmesh,
        in_specs=(spec,) * (1 + len(args)) + (P(),),
        out_specs=spec, check_vma=False,
    )
    def _mult(u, vol, minv, e0, e1, B0, B1, vnli,
              ec, Bc, vnc, role, be, bB, bvnli, gin, t):
        (u, vol, minv, e0, e1, B0, B1, vnli, ec, Bc, vnc, role, be, bB,
         bvnli, gin) = (a[0] for a in (
            u, vol, minv, e0, e1, B0, B1, vnli, ec, Bc, vnc, role, be, bB,
            bvnli, gin))
        ul = u.reshape(ne_loc, nd)

        uq = eval_values(db, ul)
        y = eval_grad_t(db, vol * uq[..., None])

        # device-local interior faces
        u0 = jnp.einsum("fqn,fn->fq", B0, ul[e0])
        u1 = jnp.einsum("fqn,fn->fq", B1, ul[e1])
        up = jnp.where(vnli >= 0.0, u0, u1)
        flux = vnli * up
        y = y.at[e0].add(-jnp.einsum("fqn,fq->fn", B0, flux))
        y = y.at[e1].add(jnp.einsum("fqn,fq->fn", B1, flux))

        # cross faces: one ppermute per color
        for c in range(ncolors):
            own = jnp.einsum("fqn,fn->fq", Bc[c], ul[ec[c]])
            recv = lax.ppermute(own, pops.AXIS, perms[c])
            r = role[c][:, None]
            u0c = jnp.where(r, own, recv)
            u1c = jnp.where(r, recv, own)
            upc = jnp.where(vnc[c] >= 0.0, u0c, u1c)
            fx = vnc[c] * upc
            sgn = jnp.where(r, -1.0, 1.0).astype(fx.dtype)
            y = y.at[ec[c]].add(
                jnp.einsum("fqn,fq->fn", Bc[c], sgn * fx))

        # boundary
        ub = jnp.einsum("fqn,fn->fq", bB, ul[be])
        val = jnp.where(bvnli >= 0.0, ub, gin)
        y = y.at[be].add(-jnp.einsum("fqn,fq->fn", bB, bvnli * val))

        out = jnp.einsum("emn,en->em", minv, y)
        return out.reshape(1, -1)

    jmult = jax.jit(_mult)

    def mult(t, u_stacked):
        return jmult(u_stacked, *args, jnp.asarray(t, rt))

    return ParDGAdvection(
        fes=fes, dmesh=dmesh, parts=parts, elems=elems, ne_loc=ne_loc,
        mult=mult,
    )


# ======================================================================
# sharded SIPG diffusion (ex14p analog)
# ======================================================================

@dataclasses.dataclass(eq=False)
class ParDGDiffusion:
    """Sharded SIPG operator with ghost-face exchange; solve() runs a
    sharded Jacobi-PCG entirely under shard_map."""

    fes: object
    dmesh: DeviceMesh
    parts: np.ndarray
    elems: np.ndarray
    ne_loc: int
    mult: Callable                 # u_stacked -> A u (stacked)
    solve: Callable                # (rel_tol, max_iter) -> (u_stacked, info)
    b: jnp.ndarray                 # stacked RHS
    diag: jnp.ndarray              # stacked Jacobi diagonal

    scatter = ParDGAdvection.scatter
    gather = ParDGAdvection.gather


def setup_sipg(
    fes,
    kappa: float = 1.0,
    penalty: float = 10.0,
    g: Optional[Callable] = None,      # Dirichlet data (weak)
    f_rhs: Optional[Callable] = None,  # volume source
    ndev: Optional[int] = None,
    devices=None,
    nq1d: Optional[int] = None,
    dtype=None,
    parts: Optional[np.ndarray] = None,
) -> ParDGDiffusion:
    from ..linalg.solvers import cg
    from ..ops.dg_diffusion import DGDiffusion
    from ..ops import diffusion as dmod

    mesh = fes.mesh
    rt = real_t(dtype)
    if devices is None:
        devices = jax.devices()
    if ndev is None:
        ndev = len(devices)
    dmesh = DeviceMesh(np.array(devices[:ndev]), (pops.AXIS,))
    if parts is None:
        parts = partition_mesh(mesh, ndev)

    # serial operator provides all global tables (setup-time only)
    ser = DGDiffusion(fes=fes, kappa=kappa, penalty=penalty, nq1d=nq1d,
                      dtype=dtype)
    db = ser.db
    nd = fes.nd_elem
    ne = mesh.ne
    nqf = ser.B0.shape[1]

    dev_elems = [np.nonzero(parts == d)[0] for d in range(ndev)]
    ne_loc = max(len(e) for e in dev_elems)
    elems = np.full((ndev, ne_loc), -1, dtype=np.int64)
    g2l = np.full(ne, -1, dtype=np.int64)
    for d, e in enumerate(dev_elems):
        elems[d, : len(e)] = e
        g2l[e] = np.arange(len(e))

    def stack_elem(arrg, axis=0):
        arrg = np.asarray(arrg)
        out = np.zeros((ndev, ne_loc) + arrg.shape[1:], arrg.dtype)
        for d, e in enumerate(dev_elems):
            out[d, : len(e)] = arrg[e]
        return out

    # volume qdata: packed (6|3, ne, nq) → per-device (6|3, ne_loc, nq)
    vq = np.asarray(ser.vol_qd)
    vol_s = np.zeros((ndev,) + (vq.shape[0], ne_loc, vq.shape[2]), vq.dtype)
    for d, e in enumerate(dev_elems):
        vol_s[d][:, : len(e)] = vq[:, e]
    vol_j = jnp.asarray(vol_s, rt)

    e0g = np.asarray(ser.e0)
    e1g = np.asarray(ser.e1)
    d0 = parts[e0g]
    d1 = parts[e1g]
    local = d0 == d1

    def face_stack(sel_per_dev, *arrs):
        n = max((len(s) for s in sel_per_dev), default=0)
        n = max(n, 1)
        outs = []
        for a in arrs:
            a = np.asarray(a)
            o = np.zeros((ndev, n) + a.shape[1:], a.dtype)
            for d, s in enumerate(sel_per_dev):
                o[d, : len(s)] = a[s]
            outs.append(o)
        return n, outs

    # local interior faces
    sel_loc = [np.nonzero(local & (d0 == d))[0] for d in range(ndev)]
    _, (B0l, B1l, N0l, N1l, wfl, penl) = face_stack(
        sel_loc, ser.B0, ser.B1, ser.N0, ser.N1, ser.w_f,
        np.asarray(ser.pen))
    nfl = B0l.shape[1]
    e0l = np.zeros((ndev, nfl), np.int64)
    e1l = np.zeros((ndev, nfl), np.int64)
    for d, s in enumerate(sel_loc):
        e0l[d, : len(s)] = g2l[e0g[s]]
        e1l[d, : len(s)] = g2l[e1g[s]]

    # cross faces, edge-colored
    cross_idx = np.nonzero(~local)[0]
    pairs = sorted({(min(d0[f], d1[f]), max(d0[f], d1[f]))
                    for f in cross_idx})
    colors = _edge_color(list(pairs))
    ncolors = max(len(colors), 0)
    pair_color = {pr: c for c, cls in enumerate(colors) for pr in cls}
    face_lists = [[[] for _ in range(max(ncolors, 1))] for _ in range(ndev)]
    for f in cross_idx:
        pr = (min(d0[f], d1[f]), max(d0[f], d1[f]))
        c = pair_color[pr]
        face_lists[d0[f]][c].append((f, 0))
        face_lists[d1[f]][c].append((f, 1))
    nfc = max((len(fl) for dev in face_lists for fl in dev), default=0)
    nfc = max(nfc, 1)
    ncolors = max(ncolors, 1) if cross_idx.size else 0

    ecx = np.zeros((ndev, max(ncolors, 1), nfc), np.int64)
    Bcx = np.zeros((ndev, max(ncolors, 1), nfc, nqf, nd),
                   np.asarray(ser.B0).dtype)
    Ncx = np.zeros_like(Bcx)
    wcx = np.zeros((ndev, max(ncolors, 1), nfc, nqf),
                   np.asarray(ser.w_f).dtype)
    pencx = np.zeros((ndev, max(ncolors, 1), nfc),
                     np.asarray(ser.pen).dtype)
    rolex = np.zeros((ndev, max(ncolors, 1), nfc), bool)
    B0g, B1g = np.asarray(ser.B0), np.asarray(ser.B1)
    N0g, N1g = np.asarray(ser.N0), np.asarray(ser.N1)
    wfg, peng = np.asarray(ser.w_f), np.asarray(ser.pen)
    for d in range(ndev):
        for c in range(max(ncolors, 1)):
            fl = sorted(face_lists[d][c])
            for i, (f, side) in enumerate(fl):
                eg = e0g[f] if side == 0 else e1g[f]
                ecx[d, c, i] = g2l[eg]
                Bcx[d, c, i] = B0g[f] if side == 0 else B1g[f]
                Ncx[d, c, i] = N0g[f] if side == 0 else N1g[f]
                wcx[d, c, i] = wfg[f]
                pencx[d, c, i] = peng[f]
                rolex[d, c, i] = side == 0

    perms = []
    for cls in colors:
        pr = []
        for a, b_ in cls:
            pr.append((a, b_))
            pr.append((b_, a))
        perms.append(tuple(pr))
    perms = tuple(perms)

    # boundary faces
    beg = np.asarray(ser.be)
    bd = parts[beg]
    sel_b = [np.nonzero(bd == d)[0] for d in range(ndev)]
    _, (bBl, bNl, bwl, bpenl) = face_stack(
        sel_b, ser.bB, ser.bN, ser.bw, np.asarray(ser.bpen))
    nfb = bBl.shape[1]
    bel = np.zeros((ndev, nfb), np.int64)
    for d, s in enumerate(sel_b):
        bel[d, : len(s)] = g2l[beg[s]]

    # RHS and diagonal: global (serial) → element-stacked
    bg = np.zeros(ne * nd)
    if g is not None:
        bg = bg + np.asarray(ser.dirichlet_rhs(g))
    if f_rhs is not None:
        gfv = geom_factors_for(fes, nq1d, dtype)
        from ..fem.quadinterp import eval_values_t

        fq = jnp.asarray(f_rhs(gfv.x), rt)
        bg = bg + np.asarray(
            eval_values_t(db, gfv.wdet * fq)).reshape(-1)
    diag_g = np.asarray(ser.diagonal())
    b_s = jnp.asarray(stack_elem(bg.reshape(ne, nd)).reshape(ndev, -1), rt)
    diag_s = np.maximum(stack_elem(diag_g.reshape(ne, nd)), 0.0)
    diag_s[diag_s == 0.0] = 1.0
    diag_j = jnp.asarray(diag_s.reshape(ndev, -1), rt)

    cast = lambda a: jnp.asarray(a.astype(np.float64), rt) if (
        a.dtype.kind == "f") else jnp.asarray(a)
    tabs = dict(
        e0=jnp.asarray(e0l, index_t()), e1=jnp.asarray(e1l, index_t()),
        B0=cast(B0l), B1=cast(B1l), N0=cast(N0l), N1=cast(N1l),
        wf=cast(wfl), pen=cast(penl),
        ec=jnp.asarray(ecx, index_t()), Bc=cast(Bcx), Nc=cast(Ncx),
        wc=cast(wcx), penc=cast(pencx), role=jnp.asarray(rolex),
        be=jnp.asarray(bel, index_t()), bB=cast(bBl), bN=cast(bNl),
        bw=cast(bwl), bpen=cast(bpenl),
    )
    names = list(tabs)
    tabvals = tuple(tabs[k] for k in names)
    spec = P(pops.AXIS)

    def local_mult(ul, vol, T):
        """Device-local SIPG apply; T = dict of this device's tables."""
        y = dmod.apply(db, vol, ul)

        u0 = jnp.einsum("fqn,fn->fq", T["B0"], ul[T["e0"]])
        u1 = jnp.einsum("fqn,fn->fq", T["B1"], ul[T["e1"]])
        du0 = jnp.einsum("fqn,fn->fq", T["N0"], ul[T["e0"]])
        du1 = jnp.einsum("fqn,fn->fq", T["N1"], ul[T["e1"]])
        jump = u0 - u1
        t = T["wf"] * 0.5 * (du0 + du1)
        y = y.at[T["e0"]].add(-jnp.einsum("fqn,fq->fn", T["B0"], t))
        y = y.at[T["e1"]].add(jnp.einsum("fqn,fq->fn", T["B1"], t))
        s = 0.5 * T["wf"] * jump
        y = y.at[T["e0"]].add(-jnp.einsum("fqn,fq->fn", T["N0"], s))
        y = y.at[T["e1"]].add(-jnp.einsum("fqn,fq->fn", T["N1"], s))
        pw = T["pen"][:, None] * T["wf"] * jump
        y = y.at[T["e0"]].add(jnp.einsum("fqn,fq->fn", T["B0"], pw))
        y = y.at[T["e1"]].add(-jnp.einsum("fqn,fq->fn", T["B1"], pw))

        # cross faces
        for c in range(ncolors):
            own_u = jnp.einsum("fqn,fn->fq", T["Bc"][c], ul[T["ec"][c]])
            own_du = jnp.einsum("fqn,fn->fq", T["Nc"][c], ul[T["ec"][c]])
            buf = jnp.concatenate([own_u, own_du], axis=-1)
            recv = lax.ppermute(buf, pops.AXIS, perms[c])
            r_u, r_du = recv[:, :nqf], recv[:, nqf:]
            r = T["role"][c][:, None]
            u0c = jnp.where(r, own_u, r_u)
            u1c = jnp.where(r, r_u, own_u)
            du0c = jnp.where(r, own_du, r_du)
            du1c = jnp.where(r, r_du, own_du)
            jmp = u0c - u1c
            wc = T["wc"][c]
            # consistency: side0 −, side1 +
            sgn_c = jnp.where(r, -1.0, 1.0).astype(wc.dtype)
            y = y.at[T["ec"][c]].add(jnp.einsum(
                "fqn,fq->fn", T["Bc"][c],
                sgn_c * wc * 0.5 * (du0c + du1c)))
            # symmetry: both sides −Nᵀ(0.5 w jump)
            y = y.at[T["ec"][c]].add(-jnp.einsum(
                "fqn,fq->fn", T["Nc"][c], 0.5 * wc * jmp))
            # penalty: side0 +, side1 −
            pwc = T["penc"][c][:, None] * wc * jmp
            y = y.at[T["ec"][c]].add(jnp.einsum(
                "fqn,fq->fn", T["Bc"][c], -sgn_c * pwc))

        # boundary (weak Dirichlet, operator side u⁺ ≡ 0)
        ub = jnp.einsum("fqn,fn->fq", T["bB"], ul[T["be"]])
        dub = jnp.einsum("fqn,fn->fq", T["bN"], ul[T["be"]])
        y = y.at[T["be"]].add(
            -jnp.einsum("fqn,fq->fn", T["bB"], T["bw"] * dub)
            - jnp.einsum("fqn,fq->fn", T["bN"], T["bw"] * ub)
            + jnp.einsum("fqn,fq->fn", T["bB"],
                         T["bpen"][:, None] * T["bw"] * ub)
        )
        return y

    nt = len(tabvals)

    @fpartial(
        shard_map, mesh=dmesh, in_specs=(spec, spec) + (spec,) * nt,
        out_specs=spec, check_vma=False,
    )
    def _mult(u, vol, *tv):
        u, vol = u[0], vol[0]
        T = {k: v[0] for k, v in zip(names, tv)}
        y = local_mult(u.reshape(ne_loc, nd), vol, T)
        return y.reshape(1, -1)

    jmult = jax.jit(_mult)

    def mult(u_stacked):
        return jmult(u_stacked, vol_j, *tabvals)

    @fpartial(
        shard_map, mesh=dmesh,
        in_specs=(spec, spec, spec) + (spec,) * nt + (P(), P()),
        out_specs=(spec, P(), P()), check_vma=False,
    )
    def _solve(bb, dgj, vol, *tv_and_tols):
        tv = tv_and_tols[:nt]
        rel_tol_, max_iter_ = tv_and_tols[nt], tv_and_tols[nt + 1]
        bb, dgj, vol = bb[0], dgj[0], vol[0]
        T = {k: v[0] for k, v in zip(names, tv)}

        def A(v):
            return local_mult(v.reshape(ne_loc, nd), vol, T).reshape(-1)

        def pdot(a, b_):
            x = a * b_
            if jax.config.jax_enable_x64 and x.dtype != jnp.float64:
                x = x.astype(jnp.float64)
            return lax.psum(jnp.sum(x), pops.AXIS).astype(a.dtype)

        x, info = cg(A, bb, M=lambda rr: rr / dgj, rel_tol=rel_tol_,
                     max_iter=max_iter_, dot=pdot)
        return x[None], info.iterations, info.final_norm

    jsolve = jax.jit(_solve, static_argnames=())

    def solve(rel_tol=1e-10, max_iter=2000):
        x, iters, fin = jsolve(b_s, diag_j, vol_j, *tabvals,
                               rel_tol, max_iter)
        return x, (int(iters), float(fin))

    return ParDGDiffusion(
        fes=fes, dmesh=dmesh, parts=parts, elems=elems, ne_loc=ne_loc,
        mult=mult, solve=solve, b=b_s, diag=diag_j,
    )
