"""Sharded p-multigrid V-cycle — parallel preconditioning beyond smoothers.

Reference analog: ``Multigrid`` over a ``FiniteElementSpaceHierarchy``
(``fem/multigrid.hpp:135,165``) with ``PRefinementTransferOperator``
(``fem/transfer.hpp:566``) transfers, used as a parallel preconditioner the
way ex26p uses GeometricMultigrid (the designated BoomerAMG substitute,
SURVEY.md §2.6 item 1).

Design: the whole V-cycle runs *inside* one ``shard_map`` region.  All
levels share the fine level's element partition, so the p-transfer is
element-local (one interpolation einsum) followed by the standard
scatter + halo assembly; no extra communication structure is needed beyond
each level's own halo schedule.  Host side builds, per coarse level, the
same stacked tables as ``pfespace.build`` plus the 1D interpolation matrix;
in-shard, ``inshard_vcycle`` wires Chebyshev-smoothed levels into a jittable
V-cycle closure usable as the CG preconditioner ``M``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..fem.basis import h1_nodes_1d, lagrange_matrices
from ..fem.fespace import FESpace
from ..fem.geom_factors import compute_geometric_factors
from ..fem.geometry import DIMENSION
from ..fem.quadinterp import DeviceBasis, device_basis, eval_values, eval_values_t
from ..linalg.smoothers import chebyshev
from ..linalg.solvers import cg
from ..utils.config import real_t
from . import ops as pops
from .pfespace import ParFESpace, build


@dataclasses.dataclass(eq=False)
class PMGLevel:
    """Host-side stacked arrays for one coarse level (device axis leading)."""

    pf: ParFESpace
    gather: jnp.ndarray          # (ndev, ne_loc, nd_c)
    scat_perm: jnp.ndarray
    scat_seg: jnp.ndarray
    send_idx: jnp.ndarray
    ess_loc: jnp.ndarray         # (ndev, m) local essential dofs (pad → nloc)
    node_coords: jnp.ndarray     # (ndev, ne_loc, nd_geo, sdim)
    dof_weight: jnp.ndarray      # (ndev, nloc+1)
    loc2glob: jnp.ndarray        # (ndev, nloc+1) for deterministic v0 seeds
    db: DeviceBasis              # operator basis (order p_l quadrature)
    interp: DeviceBasis          # THIS level's nodes ← next-coarser basis
    d2q: object


@dataclasses.dataclass(eq=False)
class PMGContext:
    """Coarse levels (coarsest first) below an externally-owned fine level."""

    levels: List[PMGLevel]
    interp_fine: DeviceBasis     # fine nodes ← levels[-1] basis
    orders: Sequence[int]


def _stack_local_ess(pf: ParFESpace, ess_global: np.ndarray) -> np.ndarray:
    rows = []
    for d in range(pf.ndev):
        g = pf.loc2glob[d]
        mask = np.isin(g, ess_global) & (g >= 0)
        rows.append(np.nonzero(mask)[0])
    m = max([len(r) for r in rows] + [1])
    out = np.full((pf.ndev, m), pf.nloc, dtype=np.int32)
    for d, r in enumerate(rows):
        out[d, : len(r)] = r
    return out


def _interp_basis(geom, pc: int, pf_ord: int, dtype) -> DeviceBasis:
    rt = real_t(dtype)
    I1, _ = lagrange_matrices(h1_nodes_1d(pc), h1_nodes_1d(pf_ord))
    return DeviceBasis(
        dim=DIMENSION[geom], tensor=True,
        B1=jnp.asarray(I1, rt), G1=jnp.asarray(np.zeros_like(I1), rt), W=None,
    )


def build_coarse_levels(
    fine_fes: FESpace,
    fine_pf: ParFESpace,
    orders: Sequence[int],
    ess_bdr,
    dtype=None,
) -> PMGContext:
    """Build coarse-level tables under the fine level's element partition.

    ``orders`` lists the coarse orders coarsest→finest (excluding the fine
    order), e.g. ``(1,)`` for a 2-level p-MG on a p=2 fine space.
    """
    mesh = fine_fes.mesh
    geom = mesh.geom
    levels: List[PMGLevel] = []
    prev_order: Optional[int] = None
    for p in orders:
        fes = FESpace(mesh, p)
        pf = build(fes, fine_pf.ndev, parts=fine_pf.parts)
        ess_global = fes.essential_dofs(ess_bdr) if (
            ess_bdr is None or len(list(ess_bdr)) > 0
        ) else np.zeros(0, np.int32)
        l2g = np.concatenate(
            [pf.loc2glob, np.full((pf.ndev, 1), -1, pf.loc2glob.dtype)], axis=1
        )
        levels.append(PMGLevel(
            pf=pf,
            gather=jnp.asarray(pf.gather),
            scat_perm=jnp.asarray(pf.scat_perm),
            scat_seg=jnp.asarray(pf.scat_seg),
            send_idx=jnp.asarray(pf.send_idx),
            ess_loc=jnp.asarray(_stack_local_ess(pf, ess_global)),
            node_coords=jnp.asarray(pf.node_coords, real_t(dtype)),
            dof_weight=jnp.asarray(pf.dof_weight, real_t(dtype)),
            loc2glob=jnp.asarray(l2g),
            db=device_basis(fes.d2q, dtype),
            interp=(
                _interp_basis(geom, prev_order, p, dtype)
                if prev_order is not None else None
            ),
            d2q=fes.d2q,
        ))
        prev_order = p
    interp_fine = _interp_basis(geom, orders[-1], fine_fes.order, dtype)
    return PMGContext(levels=levels, interp_fine=interp_fine,
                      orders=tuple(orders))


def inshard_vcycle(
    ctx: PMGContext,
    *,
    axis_name: str,
    fine: dict,
    qdata_fn: Callable,
    smoother_order: int = 3,
    power_iters: int = 12,
    coarse_iters: int = 32,
    coarse_tol: float = 1e-8,
):
    """Call INSIDE shard_map: returns the V-cycle preconditioner closure.

    ``fine`` supplies the externally-built fine level::

        {A, diag, gather, scat_perm, scat_seg, send_idx, perms, nloc,
         emask, pdot, smoother}           # smoother optional

    ``qdata_fn(gf, level_index, db)`` returns ``(qd_mass, qd_diff)`` for the
    coarse operator at that level (either may be None); it must already fold
    in the element pad weights.
    """
    idx = lax.axis_index(axis_name)
    rt = fine["diag"].dtype
    # pad-element mask (same element partition on every level): padded slots
    # replicate element 0, so unweighted transfer scatters would double-count
    w_el = fine["elem_weight"].astype(rt)            # (ne_loc,)

    # ---- per-coarse-level local ops ------------------------------------
    coarse = []
    for li, lv in enumerate(ctx.levels):
        g = lv.gather[idx]
        pm = lv.scat_perm[idx]
        sg = lv.scat_seg[idx]
        sd = lv.send_idx[idx]
        ess = lv.ess_loc[idx]
        nloc = lv.pf.nloc
        perms = lv.pf.perms
        w_dof = lv.dof_weight[idx]
        emask = jnp.ones(nloc + 1, rt).at[ess].set(0.0)
        emask = emask.at[nloc].set(0.0)

        def assemble(e, pm=pm, sg=sg, sd=sd, nloc=nloc, perms=perms):
            y = pops.local_scatter(e, pm, sg, nloc)
            return pops.halo_sum(y, sd, perms, nloc)

        X = lv.node_coords[idx]
        gf = compute_geometric_factors(X, lv.d2q, rt)
        qd_mass, qd_diff = qdata_fn(gf, li, lv.db)

        def A(v, g=g, db=lv.db, qm=qd_mass, qdf=qd_diff,
              assemble=assemble, emask=emask):
            from ..ops import diffusion as diffusion_mod
            from ..ops import mass as mass_mod

            z = v * emask
            e = z[g]
            out = 0.0
            if qdf is not None:
                out = diffusion_mod.apply(db, qdf, e)
            if qm is not None:
                out = out + mass_mod.apply(db, qm, e)
            y = assemble(out)
            return y * emask + (v - z)

        def diag_of(g=g, db=lv.db, qm=qd_mass, qdf=qd_diff,
                    assemble=assemble, emask=emask, nloc=nloc):
            from ..ops import diffusion as diffusion_mod
            from ..ops import mass as mass_mod

            d_e = 0.0
            if qdf is not None:
                d_e = diffusion_mod.diagonal(db, qdf)
            if qm is not None:
                d_e = d_e + mass_mod.diagonal(db, qm)
            dg = assemble(d_e)
            dg = dg * emask + (1.0 - emask)
            dg = dg.at[nloc].set(1.0)
            return jnp.where(dg == 0.0, 1.0, dg)

        dg = diag_of()
        pdot = pops.make_pdot(w_dof, axis_name)
        g2l = lv.loc2glob[idx]
        v0 = jnp.sin(0.7 + 1.61803 * g2l.astype(rt))
        v0 = v0.at[nloc].set(0.0) * (w_dof > 0)
        sm = chebyshev(A, dg, order=smoother_order, dot=pdot,
                       power_iters=power_iters, v0=v0)

        # global inverse multiplicity of THIS level's dofs (for averaging
        # prolongated values): assembled count over REAL elements only
        mult = assemble(w_el[:, None] * jnp.ones(g.shape, rt))
        inv_mult = jnp.where(mult > 0, 1.0 / jnp.where(mult == 0, 1.0, mult),
                             0.0)

        coarse.append(dict(A=A, diag=dg, smoother=sm, pdot=pdot,
                           gather=g, assemble=assemble, emask=emask,
                           inv_mult=inv_mult, nloc=nloc,
                           interp=lv.interp))

    # ---- fine level -----------------------------------------------------
    f_gather = fine["gather"]
    f_nloc = fine["nloc"]

    def f_assemble(e):
        y = pops.local_scatter(e, fine["scat_perm"], fine["scat_seg"], f_nloc)
        return pops.halo_sum(y, fine["send_idx"], fine["perms"], f_nloc)

    f_emask = fine["emask"]
    f_A = fine["A"]
    f_sm = fine.get("smoother")
    if f_sm is None:
        g2l = fine["loc2glob"]
        v0 = jnp.sin(0.7 + 1.61803 * g2l.astype(rt))
        v0 = v0.at[f_nloc].set(0.0) * (fine["dof_weight"] > 0)
        f_sm = chebyshev(f_A, fine["diag"], order=smoother_order,
                         dot=fine["pdot"], power_iters=power_iters, v0=v0)
    f_mult = f_assemble(w_el[:, None] * jnp.ones(f_gather.shape, rt))
    f_inv_mult = jnp.where(f_mult > 0,
                           1.0 / jnp.where(f_mult == 0, 1.0, f_mult), 0.0)

    # ---- transfers (pad elements weighted out on the scatter side) ------
    def prolong_to_fine(uc):
        e = eval_values(ctx.interp_fine, uc[coarse[-1]["gather"]])
        return f_inv_mult * f_assemble(w_el[:, None] * e)

    def restrict_from_fine(rf):
        e = eval_values_t(ctx.interp_fine, (f_inv_mult * rf)[f_gather])
        return coarse[-1]["assemble"](w_el[:, None] * e)

    def prolong(li, uc):
        """coarse level li-1 → li."""
        lvl = coarse[li]
        e = eval_values(lvl["interp"], uc[coarse[li - 1]["gather"]])
        return lvl["inv_mult"] * lvl["assemble"](w_el[:, None] * e)

    def restrict(li, rf):
        """coarse level li → li-1."""
        lvl = coarse[li]
        e = eval_values_t(lvl["interp"],
                          (lvl["inv_mult"] * rf)[lvl["gather"]])
        return coarse[li - 1]["assemble"](w_el[:, None] * e)

    # ---- V-cycle (python recursion, fully traced) -----------------------
    def coarse_solve(b):
        lvl = coarse[0]
        x, _ = cg(lvl["A"], b, M=lambda r: r / lvl["diag"],
                  rel_tol=coarse_tol, max_iter=coarse_iters,
                  dot=lvl["pdot"])
        return x

    def v_coarse(b, li):
        if li == 0:
            return coarse_solve(b)
        lvl = coarse[li]
        x = lvl["smoother"](b)
        r = b - lvl["A"](x)
        rc = restrict(li, r) * coarse[li - 1]["emask"]
        ec = v_coarse(rc, li - 1)
        x = x + prolong(li, ec)
        return x + lvl["smoother"](b - lvl["A"](x))

    def M(b):
        x = f_sm(b)
        r = b - f_A(x)
        rc = restrict_from_fine(r) * coarse[-1]["emask"]
        ec = v_coarse(rc, len(coarse) - 1)
        x = x + prolong_to_fine(ec)
        return x + f_sm(b - f_A(x))

    return M
