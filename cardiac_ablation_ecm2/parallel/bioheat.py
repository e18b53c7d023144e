"""Sharded Pennes bioheat stepping — the production path for BASELINE
config 5 (1M-element cardiac mesh over a device mesh with halo exchange).

The full implicit SDIRK timestep — stage CG solves (gather → einsum apply →
scatter → ppermute halo → psum dot), Arrhenius damage accumulation — runs as
ONE jitted shard_map region per step.  Setup (qdata, RHS, diagonals) is itself
a sharded one-shot computation so no O(global) array ever materializes on a
single device.

Reference analog: the ex16p/joule time loop (SURVEY.md §3.4) on ParMesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial as fpartial
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

from ..fem.fespace import FESpace
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_values_t
from ..linalg import ode
from ..linalg.solvers import cg
from ..ops import diffusion as dmod
from ..ops import mass as mmod
from ..utils.config import real_t
from . import ops as pops
from .pfespace import ParFESpace, build, gather_global
from .poisson import _stack_local_ess


@dataclasses.dataclass(eq=False)
class ParBioheat:
    pf: ParFESpace
    dmesh: DeviceMesh
    step: Callable            # (T_loc, t, dt) -> (T_loc, t)
    T0: jnp.ndarray           # stacked initial state (ndev, nloc+1)

    def gather(self, T_loc) -> np.ndarray:
        return gather_global(self.pf, np.asarray(T_loc))


def setup(
    mesh,
    order: int = 2,
    ndev: Optional[int] = None,
    rho_c: float = 3.6e6,
    k: float = 0.54,
    w_cb: float = 20000.0,
    T_a: float = 37.0,
    q_src: Optional[Callable] = None,     # Q_met + Q_rf as f(x) [W/m³]
    ess_bdr: Optional[Sequence[int]] = None,
    solver: str = "sdirk33",
    rel_tol: float = 1e-10,
    max_iter: int = 500,
    dtype=None,
    devices=None,
    precond: str = "jacobi",      # "jacobi" | "chebyshev" | "pmg"
    cheb_order: int = 4,
    cheb_power_iters: int = 12,
    pmg_orders: Optional[Sequence[int]] = None,
) -> ParBioheat:
    fes = FESpace(mesh, order)
    if devices is None:
        devices = jax.devices()
    if ndev is None:
        ndev = len(devices)
    pf = build(fes, ndev)
    dmesh = DeviceMesh(np.array(devices[:ndev]), (pops.AXIS,))
    d2q = fes.d2q
    db = device_basis(d2q, dtype)
    rt = real_t(dtype)
    tab = ode.select(solver).tableau
    nloc = pf.nloc
    perms = pf.perms

    if ess_bdr:
        ess_global = fes.essential_dofs(ess_bdr)
    else:
        ess_global = np.zeros(0, np.int32)
    essl = jnp.asarray(_stack_local_ess(pf, ess_global))

    Xs = jnp.asarray(pf.node_coords, dtype=rt)
    gth = jnp.asarray(pf.gather)
    pm = jnp.asarray(pf.scat_perm)
    sg = jnp.asarray(pf.scat_seg)
    sd = jnp.asarray(pf.send_idx)
    ew = jnp.asarray(pf.elem_weight, dtype=rt)
    ews = ew                       # closure copy indexed inside the step
    dw = jnp.asarray(pf.dof_weight, dtype=rt)

    spec = P(pops.AXIS)

    # ---------------- sharded one-shot setup --------------------------
    @fpartial(
        shard_map, mesh=dmesh, in_specs=(spec,) * 6,
        out_specs=(spec,) * 5, check_vma=False,
    )
    def _setup(X, g, pmi, sgi, sdi, w_el):
        X, g, pmi, sgi, sdi, w_el = (
            X[0], g[0], pmi[0], sgi[0], sdi[0], w_el[0]
        )
        ess = essl[lax.axis_index(pops.AXIS)]
        gf = compute_geometric_factors(X, d2q, dtype)
        wm = w_el[:, None]
        qd_mrc = mmod.setup(gf) * rho_c * wm
        qd_mw = mmod.setup(gf) * w_cb * wm
        qd_k = dmod.setup(gf) * k * wm[..., None, None]
        # constant rhs: M_ω T_a 1 + (q_src, v)
        q = qd_mw * T_a
        if q_src is not None:
            q = q + gf.wdet * q_src(gf.x).astype(rt) * wm
        b = pops.local_scatter(eval_values_t(db, q), pmi, sgi, nloc)
        b = pops.halo_sum(b, sdi, perms, nloc)
        b = pops.zero_at(b, ess)
        # diagonals
        dM = pops.local_scatter(mmod.diagonal(db, qd_mrc), pmi, sgi, nloc)
        dM = pops.halo_sum(dM, sdi, perms, nloc)
        dA = pops.local_scatter(
            dmod.diagonal(db, qd_k) + mmod.diagonal(db, qd_mw), pmi, sgi, nloc
        )
        dA = pops.halo_sum(dA, sdi, perms, nloc)
        return qd_mrc[None], qd_mw[None], qd_k[None], b[None], jnp.stack(
            [dM, dA]
        )[None]

    qd_mrc, qd_mw, qd_k, b_const, diags = jax.jit(_setup)(
        Xs, gth, pm, sg, sd, ew
    )

    # local → global dof ids, padded with -1 at the trash slot (used for a
    # deterministic halo-consistent Chebyshev power-iteration start)
    l2g = np.concatenate(
        [pf.loc2glob, np.full((ndev, 1), -1, pf.loc2glob.dtype)], axis=1
    )
    l2gj = jnp.asarray(l2g)

    pmg_ctx = None
    if precond == "pmg":
        from . import pmg as pmg_mod

        if pmg_orders is None:
            pmg_orders = []
            p = order // 2
            while p >= 1:
                pmg_orders.insert(0, p)
                p //= 2
            pmg_orders = pmg_orders or [1]
        pmg_ctx = pmg_mod.build_coarse_levels(
            fes, pf, pmg_orders, list(ess_bdr) if ess_bdr else [], dtype
        )

    # ---------------- sharded SDIRK step ------------------------------
    @fpartial(
        shard_map, mesh=dmesh,
        in_specs=(spec,) * 12 + (P(), P()),
        out_specs=(spec, P()),
        check_vma=False,
    )
    def step_fn(T, g, pmi, sgi, sdi, w_dof, g2l_s, qmrc, qmw, qk, bc, dgs,
                t, dt):
        T, g, pmi, sgi, sdi, w_dof, g2l = (
            T[0], g[0], pmi[0], sgi[0], sdi[0], w_dof[0], g2l_s[0]
        )
        qmrc, qmw, qk, bc, dgs = qmrc[0], qmw[0], qk[0], bc[0], dgs[0]
        ess = essl[lax.axis_index(pops.AXIS)]
        # one scatter per step builds the mask; the CG loop then uses
        # elementwise multiplies (XLA scatters cost ~2 applies each)
        emask = jnp.ones(nloc + 1, T.dtype).at[ess].set(0.0)
        dM, dA = dgs[0], dgs[1]
        pdot = pops.make_pdot(w_dof)

        def Aop(v):
            e = v[g]
            y = mmod.apply(db, qmw, e) + dmod.apply(db, qk, e)
            z = pops.local_scatter(y, pmi, sgi, nloc)
            return pops.halo_sum(z, sdi, perms, nloc)

        def Mrc(v):
            e = v[g]
            z = pops.local_scatter(mmod.apply(db, qmrc, e), pmi, sgi, nloc)
            return pops.halo_sum(z, sdi, perms, nloc)

        def zero_ess(v):
            return v * emask

        def implicit_solve(gamma, Tval):
            rhs = zero_ess(bc - Aop(Tval))

            def lhs(v):
                z = v * emask
                y = (Mrc(z) + gamma * Aop(z)) * emask
                return y + (v - z)

            dg = (dM + gamma * dA) * emask + (1.0 - emask)
            dg = dg.at[nloc].set(1.0)
            dg = jnp.where(dg == 0.0, 1.0, dg)
            if precond == "pmg":
                from . import pmg as pmg_mod

                w_el_loc = ews[lax.axis_index(pops.AXIS)]

                def qd_fn(gf_l, li, db_l):
                    wm = w_el_loc[:, None]
                    qm = mmod.setup(gf_l) * (rho_c + gamma * w_cb) * wm
                    qdf = dmod.setup(gf_l) * (gamma * k) * wm[..., None, None]
                    return qm, qdf

                fine_level = dict(
                    A=lhs, diag=dg, gather=g, scat_perm=pmi, scat_seg=sgi,
                    send_idx=sdi, perms=perms, nloc=nloc, emask=emask,
                    pdot=pdot, loc2glob=g2l, dof_weight=w_dof,
                    elem_weight=w_el_loc,
                )
                M = pmg_mod.inshard_vcycle(
                    pmg_ctx, axis_name=pops.AXIS, fine=fine_level,
                    qdata_fn=qd_fn, smoother_order=cheb_order - 1,
                    power_iters=cheb_power_iters,
                )
            elif precond == "chebyshev":
                from ..linalg.smoothers import chebyshev

                # halo-consistent deterministic start for the sharded
                # power iteration (global dof ids differ per device)
                v0 = jnp.sin(0.7 + 1.61803 * g2l.astype(dg.dtype))
                v0 = v0.at[nloc].set(0.0) * (w_dof > 0)
                M = chebyshev(lhs, dg, order=cheb_order, dot=pdot,
                              power_iters=cheb_power_iters, v0=v0)
            else:
                M = lambda r: r / dg
            x, _ = cg(lhs, rhs, M=M, rel_tol=rel_tol,
                      max_iter=max_iter, dot=pdot)
            return zero_ess(x)

        # DIRK stages (static unroll)
        ks = []
        for i in range(tab.stages):
            y = T
            for j in range(i):
                if tab.a[i, j] != 0.0:
                    y = y + (dt * float(tab.a[i, j])) * ks[j]
            ks.append(implicit_solve(float(tab.a[i, i]) * dt, y))
        Tn = T
        for i in range(tab.stages):
            if tab.b[i] != 0.0:
                Tn = Tn + (dt * float(tab.b[i])) * ks[i]
        return Tn[None], t + dt

    jit_step = jax.jit(step_fn)

    def step(T_loc, t, dt):
        return jit_step(
            T_loc, gth, pm, sg, sd, dw, l2gj, qd_mrc, qd_mw, qd_k, b_const,
            diags, jnp.asarray(t, rt), jnp.asarray(dt, rt),
        )

    T0 = jnp.full((ndev, nloc + 1), T_a, dtype=rt)
    T0 = T0.at[:, nloc].set(0.0)
    return ParBioheat(pf=pf, dmesh=dmesh, step=step, T0=T0)
