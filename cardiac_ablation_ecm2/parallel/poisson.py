"""Sharded Poisson solve — the ex1p capability slice.

Reference analog: ``examples/ex1p.cpp`` (SURVEY.md §3.3): ParMesh partition +
ParFiniteElementSpace + parallel PA apply (RAP through P) + CG with
MPI_Allreduce inner products.  Design: one ``shard_map`` region holds the
entire solve — per-device geometric factors and qdata are computed from the
device's element block, the PA apply does gather→einsum→scatter→halo
(ppermute), and CG runs with psum inner products.  The full solve is a single
jitted computation over the device mesh.
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

try:  # jax ≥ 0.6 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..fem.fespace import FESpace
from ..fem.geom_factors import compute_geometric_factors
from ..fem.quadinterp import device_basis, eval_values_t
from ..linalg.solvers import cg
from ..ops import diffusion as diffusion_mod
from ..utils.config import real_t
from . import ops as pops
from .pfespace import ParFESpace, build, gather_global


def _stack_local_ess(pf: ParFESpace, ess_global: np.ndarray) -> np.ndarray:
    """Global essential dofs → (ndev, max_ness) local indices (pad → trash)."""
    rows = []
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        valid = g >= 0
        mask = np.isin(g, ess_global) & valid
        rows.append(np.nonzero(mask)[0])
    m = max((len(r) for r in rows), default=1)
    m = max(m, 1)
    out = np.full((pf.ndev, m), pf.nloc, dtype=np.int32)
    for d, r in enumerate(rows):
        out[d, : len(r)] = r
    return out


@dataclasses.dataclass(eq=False)
class ParPoisson:
    """Assembled sharded Poisson solver (ex1p analog)."""

    pf: ParFESpace
    dmesh: DeviceMesh
    solve_fn: Callable          # (b_stub args...) -> (x_loc, iters, final)

    def solve(self, rel_tol=1e-12, max_iter=2000):
        x_loc, iters, final = self.solve_fn()
        u = gather_global(self.pf, np.asarray(x_loc)[:, : self.pf.nloc + 1])
        return u[: self.pf.ndof_global], int(iters), float(final)


def setup(
    mesh,
    order: int = 2,
    ndev: Optional[int] = None,
    rhs: Callable = None,
    kappa: Callable = None,
    ess_bdr: Optional[Sequence[int]] = None,
    rel_tol: float = 1e-12,
    max_iter: int = 2000,
    dtype=None,
    devices=None,
    precond: str = "jacobi",      # "jacobi" | "chebyshev" | "pmg"
    cheb_order: int = 4,
    cheb_power_iters: int = 12,
    pmg_orders: Optional[Sequence[int]] = None,   # coarse orders, coarsest 1st
) -> ParPoisson:
    """Build the sharded solver.  ``rhs``/``kappa`` must be jax-traceable
    callables of physical coordinates (or None)."""
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

    ess_global = fes.essential_dofs(ess_bdr) if (
        ess_bdr is None or len(list(ess_bdr)) > 0
    ) else np.zeros(0, np.int32)
    ess_loc = _stack_local_ess(pf, ess_global)

    # stacked inputs
    Xs = jnp.asarray(pf.node_coords, dtype=rt)
    gth = jnp.asarray(pf.gather)
    perm = jnp.asarray(pf.scat_perm)
    seg = jnp.asarray(pf.scat_seg)
    send = jnp.asarray(pf.send_idx)
    ew = jnp.asarray(pf.elem_weight, dtype=rt)
    dw = jnp.asarray(pf.dof_weight, dtype=rt)
    essl = jnp.asarray(ess_loc)
    nloc = pf.nloc
    perms = pf.perms
    l2gj = jnp.asarray(np.concatenate(
        [pf.loc2glob, np.full((pf.ndev, 1), -1, pf.loc2glob.dtype)], axis=1
    ))

    pmg_ctx = None
    lor_Ae = lor_slots = None
    if precond == "lor":
        # all-device LOR-MG (fem/lor/lor_batched.hpp:34 + lor.hpp:201
        # analog): batched LOR element matrices stacked per device (pad
        # elements zeroed) feed a V-cycle whose fine level is the LOR
        # operator on the order-p lattice and whose coarse level is the
        # order-1 space on the original mesh
        from ..fem.geometry import DIMENSION
        from ..ops.lor import lor_corner_slots
        from ..ops.lor_device import lor_element_matrices
        from . import pmg as pmg_mod

        assert order >= 2, "LOR preconditioning needs order >= 2"
        pmg_ctx = pmg_mod.build_coarse_levels(fes, pf, [1], ess_bdr, dtype)
        Ae, _ = lor_element_matrices(
            fes, kappa if kappa is not None else 1.0, None, dtype)
        nsub_per = order ** DIMENSION[mesh.geom]
        nv = Ae.shape[-1]
        Ae = Ae.reshape(mesh.ne, nsub_per, nv, nv)
        lor_Ae = (Ae[jnp.asarray(pf.elems)]
                  * jnp.asarray(pf.elem_weight, real_t(dtype))[
                      :, :, None, None, None])
        lor_Ae = lor_Ae.reshape(pf.ndev, -1, nv, nv)
        lor_slots = lor_corner_slots(mesh.geom, order)
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
            fes, pf, pmg_orders, ess_bdr, dtype
        )

    spec = P(pops.AXIS)

    @partial(
        shard_map,
        mesh=dmesh,
        in_specs=(spec,) * 7,
        out_specs=(spec, P(), P()),
        check_vma=False,
    )
    def _solve(X, g, pm, sg, sd, w_el, w_dof):
        X, g, pm, sg = X[0], g[0], pm[0], sg[0]
        sd, w_el, w_dof = sd[0], w_el[0], w_dof[0]
        ess = essl[lax.axis_index(pops.AXIS)]
        emask = jnp.ones(nloc + 1, rt).at[ess].set(0.0)

        gf = compute_geometric_factors(X, d2q, dtype)
        kq = None if kappa is None else kappa(gf.x).astype(rt)
        qd = diffusion_mod.setup(gf, kq) * w_el[:, None, None, None]

        def A(v):
            z = v * emask
            e = z[g]
            y = pops.local_scatter(diffusion_mod.apply(db, qd, e), pm, sg, nloc)
            y = pops.halo_sum(y, sd, perms, nloc)
            return y * emask + (v - z)

        # RHS (f, v) with halo assembly; essential rows zero (u_bc = 0)
        fq = jnp.ones_like(gf.det) if rhs is None else rhs(gf.x).astype(rt)
        b_e = eval_values_t(db, gf.wdet * fq * w_el[:, None])
        b = pops.local_scatter(b_e, pm, sg, nloc)
        b = pops.halo_sum(b, sd, perms, nloc)
        b = pops.zero_at(b, ess)

        # Jacobi diagonal with halo assembly
        d_e = diffusion_mod.diagonal(db, qd)
        dg = pops.local_scatter(d_e, pm, sg, nloc)
        dg = pops.halo_sum(dg, sd, perms, nloc)
        dg = dg * emask + (1.0 - emask)
        dg = dg.at[nloc].set(1.0)
        # unused padded dof slots (devices with fewer dofs than nloc) have a
        # zero diagonal — guard against 0/0 NaNs in the Jacobi apply
        dg = jnp.where(dg == 0.0, 1.0, dg)

        pdot = pops.make_pdot(w_dof)
        if precond == "pmg":
            from . import pmg as pmg_mod

            def qd_fn(gf_l, li, db_l):
                kq_l = None if kappa is None else kappa(gf_l.x).astype(rt)
                return None, (
                    diffusion_mod.setup(gf_l, kq_l)
                    * w_el[:, None, None, None]
                )

            fine_level = dict(
                A=A, diag=dg, gather=g, scat_perm=pm, scat_seg=sg,
                send_idx=sd, perms=perms, nloc=nloc, emask=emask,
                pdot=pdot, loc2glob=l2gj[lax.axis_index(pops.AXIS)],
                dof_weight=w_dof, elem_weight=w_el,
            )
            M = pmg_mod.inshard_vcycle(
                pmg_ctx, axis_name=pops.AXIS, fine=fine_level,
                qdata_fn=qd_fn, smoother_order=cheb_order - 1,
                power_iters=cheb_power_iters,
            )
        elif precond == "lor":
            from . import pmg as pmg_mod

            Ae_l = lor_Ae[lax.axis_index(pops.AXIS)]     # (nsub_loc, nv, nv)
            g_lor = g[:, lor_slots].reshape(-1, lor_slots.shape[1])

            def A_lor(v):
                z = v * emask
                e = z[g_lor]
                y = jnp.zeros(nloc + 1, rt).at[g_lor].add(
                    jnp.einsum("snm,sm->sn", Ae_l, e))
                y = pops.halo_sum(y, sd, perms, nloc)
                return y * emask + (v - z)

            d_lor = jnp.zeros(nloc + 1, rt).at[g_lor].add(
                jnp.diagonal(Ae_l, axis1=1, axis2=2))
            d_lor = pops.halo_sum(d_lor, sd, perms, nloc)
            d_lor = d_lor * emask + (1.0 - emask)
            d_lor = d_lor.at[nloc].set(1.0)
            d_lor = jnp.where(d_lor == 0.0, 1.0, d_lor)

            def qd_fn(gf_l, li, db_l):
                kq_l = None if kappa is None else kappa(gf_l.x).astype(rt)
                return None, (
                    diffusion_mod.setup(gf_l, kq_l)
                    * w_el[:, None, None, None]
                )

            fine_level = dict(
                A=A_lor, diag=d_lor, gather=g, scat_perm=pm, scat_seg=sg,
                send_idx=sd, perms=perms, nloc=nloc, emask=emask,
                pdot=pdot, loc2glob=l2gj[lax.axis_index(pops.AXIS)],
                dof_weight=w_dof, elem_weight=w_el,
            )
            M = pmg_mod.inshard_vcycle(
                pmg_ctx, axis_name=pops.AXIS, fine=fine_level,
                qdata_fn=qd_fn, smoother_order=cheb_order - 1,
                power_iters=cheb_power_iters,
            )
        elif precond == "chebyshev":
            from ..linalg.smoothers import chebyshev

            g2l = l2gj[lax.axis_index(pops.AXIS)]
            v0 = jnp.sin(0.7 + 1.61803 * g2l.astype(dg.dtype))
            v0 = v0.at[nloc].set(0.0) * (w_dof > 0)
            M = chebyshev(A, dg, order=cheb_order, dot=pdot,
                          power_iters=cheb_power_iters, v0=v0)
        else:
            M = lambda r: r / dg
        x, info = cg(
            A, b, M=M, rel_tol=rel_tol, max_iter=max_iter,
            dot=pdot,
        )
        return x[None], info.iterations, info.final_norm

    def run():
        return jax.jit(_solve)(Xs, gth, perm, seg, send, ew, dw)

    return ParPoisson(pf=pf, dmesh=dmesh, solve_fn=run)
