"""Sharded nonconforming (hanging-node) AMR spaces — ParNCMesh analog.

Reference analog: ``ParNCMesh`` + parallel conforming prolongation
(``mesh/ncmesh.hpp`` ghost layer, ``fem/pfespace.cpp`` Build_Dof_TrueDof
with NC constraints).

Design: shard the *broken* L-dof space exactly like a
conforming space, but augment each device's dof set with the **master
dofs of its local slaves** (the ghost layer): P and Pᵀ then become pure
device-local gathers/scatter-adds, and the ordinary symmetric halo
exchange assembles PᵀAP across devices — Pᵀ contributions written into a
ghost master copy ride the same ppermute rounds as element partial sums.
State lives in the "L-representation": conforming dofs replicated, slave
slots recomputed by P on entry and zeroed on exit."""

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

from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_values_t
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..utils.config import index_t, real_t
from . import ops as pops
from .partition import partition_mesh
from .pfespace import build, gather_global
from .poisson import _stack_local_ess


def _local_ids(g_sorted: np.ndarray, nloc: int, want: np.ndarray):
    """Global ids → local slots (trash for missing); also an ok mask."""
    pos = np.searchsorted(g_sorted, want)
    pos = np.clip(pos, 0, max(len(g_sorted) - 1, 0))
    ok = (len(g_sorted) > 0) & (g_sorted[np.clip(pos, 0,
                                                 len(g_sorted) - 1)] == want)
    return np.where(ok, pos, nloc), ok


@dataclasses.dataclass(eq=False)
class ParNCPoisson:
    pf: object
    ncsp: object
    dmesh: DeviceMesh
    solve_fn: Callable

    def solve(self):
        x_loc, iters, final = self.solve_fn()
        uL = gather_global(self.pf, np.asarray(x_loc))
        uc = uL[np.asarray(self.ncsp.L_of_conf)]
        return uc, int(iters), float(final)


def setup(
    ncsp,
    ndev: int = 8,
    rhs: Callable = None,
    ess_bdr: Optional[Sequence[int]] = None,
    rel_tol: float = 1e-12,
    max_iter: int = 3000,
    dtype=None,
    devices=None,
) -> ParNCPoisson:
    """Sharded NC Poisson (ex6p-class): −∇·∇u = f with hanging-node
    constraints, homogeneous essential BCs on ``ess_bdr`` (None = all)."""
    rt = real_t(dtype)
    fes = ncsp.fes
    mesh = fes.mesh
    if devices is None:
        devices = jax.devices()
    parts = partition_mesh(mesh, ndev)

    slave_L = np.asarray(ncsp._slave_idx)                  # (ns,)
    masters_L = np.asarray(ncsp.L_of_conf)[
        np.asarray(ncsp._slave_masters)]                   # (ns, k)
    weights = np.asarray(ncsp._slave_w)                    # (ns, k)
    ns, k = masters_L.shape

    # ghost masters per device: masters of slaves present in the device's
    # element dof set
    gm = fes.gather_map.astype(np.int64)
    extra = []
    for d in range(ndev):
        own = np.unique(gm[parts == d].reshape(-1))
        has = np.isin(slave_L, own)
        need = np.unique(masters_L[has].reshape(-1))
        extra.append(np.setdiff1d(need, own))
    pf = build(fes, ndev, parts, extra_dofs=extra)
    dmesh = DeviceMesh(np.array(devices[:ndev]), (pops.AXIS,))

    # per-device constraint tables (padded with trash slots)
    srows = [np.nonzero(np.isin(slave_L, pf.loc2glob[d]))[0]
             for d in range(ndev)]
    ns_loc = max((len(r) for r in srows), default=1)
    ns_loc = max(ns_loc, 1)
    s_idx = np.full((ndev, ns_loc), pf.nloc, dtype=np.int64)
    m_idx = np.full((ndev, ns_loc, k), pf.nloc, dtype=np.int64)
    w_tab = np.zeros((ndev, ns_loc, k))
    for d in range(ndev):
        g = pf.loc2glob[d]
        g_valid = g[g >= 0]
        r = srows[d]
        if not len(r):
            continue
        si, ok_s = _local_ids(g_valid, pf.nloc, slave_L[r])
        mi, ok_m = _local_ids(g_valid, pf.nloc,
                              masters_L[r].reshape(-1))
        assert ok_s.all() and ok_m.all(), \
            f"device {d}: NC masters missing from the ghost layer"
        s_idx[d, : len(r)] = si
        m_idx[d, : len(r)] = mi.reshape(len(r), k)
        w_tab[d, : len(r)] = weights[r]

    # conforming mask per device: 1 on conforming local dofs, 0 on slaves
    conf_mask = np.zeros((ndev, pf.nloc + 1))
    Lconf = np.asarray(ncsp.L_of_conf)
    for d in range(ndev):
        g = pf.loc2glob[d]
        valid = g >= 0
        conf_mask[d, : pf.nloc][valid] = np.isin(
            g[valid], Lconf).astype(float)

    essL = fes.essential_dofs(ess_bdr)
    ess_loc = _stack_local_ess(pf, essL)

    d2q = fes.d2q
    db = device_basis(d2q, dtype)
    Xs = jnp.asarray(pf.node_coords, rt)
    gth = jnp.asarray(pf.gather)
    perm = jnp.asarray(pf.scat_perm)
    seg = jnp.asarray(pf.scat_seg)
    send = jnp.asarray(pf.send_idx)
    ew = jnp.asarray(pf.elem_weight, rt)
    dw = jnp.asarray(pf.dof_weight, rt)
    essl = jnp.asarray(ess_loc)
    s_idx_j = jnp.asarray(s_idx, index_t())
    m_idx_j = jnp.asarray(m_idx, index_t())
    w_j = jnp.asarray(w_tab, rt)
    cm_j = jnp.asarray(conf_mask, rt)
    nloc = pf.nloc
    perms = pf.perms

    spec = P(pops.AXIS)

    @partial(shard_map, mesh=dmesh, in_specs=(spec,) * 11,
             out_specs=(spec, P(), P()), check_vma=False)
    def _solve(X, g, pm, sg, sd, w_el, w_dof, si, mi, sw, cm):
        X, g, pm, sg = X[0], g[0], pm[0], sg[0]
        sd, w_el, w_dof = sd[0], w_el[0], w_dof[0]
        si, mi, sw, cm = si[0], mi[0], sw[0], cm[0]
        ess = essl[lax.axis_index(pops.AXIS)]
        emask = jnp.ones(nloc + 1, rt).at[ess].set(0.0)
        emask = emask * cm                       # solve on conforming dofs
        emask = emask.at[nloc].set(0.0)

        gf = compute_geometric_factors(X, d2q, dtype)
        qd = dmod.setup(gf, None) * w_el[:, None, None, None]

        def Pro(v):
            sv = jnp.sum(v[mi] * sw, axis=1)
            return v.at[si].set(sv).at[nloc].set(0.0)

        def ProT(y):
            contrib = y[si][:, None] * sw
            y = y.at[mi.reshape(-1)].add(contrib.reshape(-1))
            # zero slave slots (non-conforming residual rows fold away)
            return (y * cm).at[nloc].set(0.0)

        def A(v):
            z = Pro(v * emask)
            e = z[g]
            y = pops.local_scatter(dmod.apply(db, qd, e), pm, sg, nloc)
            y = ProT(y)
            y = pops.halo_sum(y, sd, perms, nloc)
            return y * emask + (v - v * emask)

        fq = jnp.ones_like(gf.det) if rhs is None else rhs(gf.x).astype(rt)
        b_e = eval_values_t(db, gf.wdet * fq * w_el[:, None])
        b = pops.local_scatter(b_e, pm, sg, nloc)
        b = ProT(b)
        b = pops.halo_sum(b, sd, perms, nloc)
        b = b * emask

        # Jacobi diagonal of PᵀAP (diag-block approximation): element
        # diagonals scattered, slave rows folded with w² into masters
        d_e = dmod.diagonal(db, qd)
        dg = pops.local_scatter(d_e, pm, sg, nloc)
        dslave = dg[si][:, None] * sw * sw
        dg = (dg * cm).at[mi.reshape(-1)].add(dslave.reshape(-1))
        dg = pops.halo_sum(dg.at[nloc].set(0.0), sd, perms, nloc)
        dg = dg * emask + (1.0 - emask)
        dg = jnp.where(dg == 0.0, 1.0, dg)

        pdot = pops.make_pdot(w_dof * cm)
        x, info = cg(A, b, M=lambda r: r / dg, rel_tol=rel_tol,
                     max_iter=max_iter, dot=pdot)
        return x[None], info.iterations, info.final_norm

    def run():
        return jax.jit(_solve)(Xs, gth, perm, seg, send, ew, dw,
                               s_idx_j, m_idx_j, w_j, cm_j)

    return ParNCPoisson(pf=pf, ncsp=ncsp, dmesh=dmesh, solve_fn=run)
