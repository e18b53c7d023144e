"""Smoke test of the bioheat and ablation steps on the GPU.

Runs the paths users call — ``BioheatOperator`` + ``make_stepper``,
``AblationSim`` and, with ``--four-cards``, the sharded
``parallel.bioheat.setup`` — at real mesh sizes, and checks each result
against an independent reference: MFEM's ``theta_max`` where
``bench_baseline.json`` has one, a float64 SDIRK33 on scipy-assembled
matrices on the host, and the same run in float64 on the card.

    python chip_smoke.py                # one card: every one-card phase
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

Prints the card and JAX versions, then one JSON object per phase, then the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a GPU, or when any phase fails,
it exits non-zero and prints no such line.  Everything runs in this one
process; the only child process is ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# The bench/MFEM configuration (bench.py, tools/mfem_bioheat_bench.cpp):
# linear Pennes in theta form, H1 order 2, SDIRK33, Jacobi-PCG.
ORDER = 2
RHO_C, K_TH, W_CB, T_A = 3.6e6, 0.54, 2e4, 37.0
DT, NSTEPS = 0.25, 3           # MFEM's warm-up step + 2 timed steps
TIMED_STEPS = 5
L = 0.04                       # lattice edge; cardiac block is L x L x L/2
ESS_ALL = [1, 2, 3, 4, 5, 6]

# Tolerances (each with its reason in CHANGES.md).  "field" bounds are on
# max |theta - ref| / max |ref|.
TOL_F32_VS_F64 = 1e-4          # theta_max, f32 run vs the same run in f64
TOL_LATTICE_F32_VS_HOST = 1e-4  # field, f32 at rel_tol 1e-5 vs host f64
TOL_TET_F32_VS_HOST = 1e-3     # the same on cardiac tets (CG truncation)
TOL_F64_VS_HOST = 1e-10        # field, f64 at rel_tol 1e-12 vs host f64
TOL_VS_MFEM = 1e-4             # theta_max relative to MFEM's
TOL_ELL_VS_PA = 1e-10          # field, ELL vs PA, both f64 at rel_tol 1e-12
TOL_ELL_VS_SCIPY = 1e-6        # (M + gamma A) x, f32 ELL vs scipy f64
TOL_ABLATION = 5e-5            # theta_max and lesion volume, f32 vs f64
TOL_SHARDED = 1e-6             # field, 4 cards vs 1, f64 at rel_tol 1e-5

#: SDIRK33 (Alexander), written out independently of linalg/ode.py for the
#: host reference.
_G = 0.435866521508458999416019
_B1, _B2 = -1.5 * _G**2 + 4.0 * _G - 0.25, 1.5 * _G**2 - 5.0 * _G + 1.25
SDIRK33_A = ((_G, 0.0, 0.0), ((1.0 - _G) / 2.0, _G, 0.0), (_B1, _B2, _G))
SDIRK33_B = (_B1, _B2, _G)


class Checks:
    """Named comparisons, each printed with its observed value and bound."""

    def __init__(self):
        self.items = []

    def le(self, name, value, tol):
        value = float(value)
        self.items.append({"name": name, "value": value, "tol": tol,
                           "ok": bool(np.isfinite(value) and value <= tol)})

    def true(self, name, cond, value=None):
        self.items.append({"name": name, "value": value, "ok": bool(cond)})

    @property
    def ok(self):
        return all(c["ok"] for c in self.items)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _field_err(theta, ref):
    """max |theta - ref| / max |ref|."""
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(theta, np.float64) - ref))
                 / np.max(np.abs(ref)))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _baseline_row(mesh_kind, n):
    with open(os.path.join(HERE, "bench_baseline.json")) as f:
        rows = json.load(f)["cardiac"]
    match = [r for r in rows if r["mesh"] == mesh_kind and r["n"] == n]
    return match[0] if match else None


def gaussian_source(center, amp, width2):
    """amp · exp(−|x − center|² / width2) for jnp or numpy points."""

    def src(x):
        import jax.numpy as jnp

        r2 = sum((x[..., i] - center[i]) ** 2 for i in range(3))
        return amp * (np if isinstance(x, np.ndarray) else jnp).exp(
            -r2 / width2)

    return src


#: bench.py's lattice source: broad metabolic-style Gaussian at the centre.
LATTICE_SRC = gaussian_source((L / 2, L / 2, L / 2), 1e6, (L / 8) ** 2)
#: MFEM's cardiac SAR source (tools/mfem_bioheat_bench.cpp q_rf): 2e7 W/m³,
#: sigma 3 mm, at the electrode tip (Lx/2, Ly/2, Lz).
CARDIAC_SRC = gaussian_source((L / 2, L / 2, L / 2), 2e7, 2 * 0.003**2)


# ----------------------------------------------------------------------
# the system under test
# ----------------------------------------------------------------------

def run_bioheat(fes, src, *, dtype, rel_tol, ess_bdr=ESS_ALL, timed=0,
                **kw):
    """BioheatOperator + make_stepper as bench.py drives them: theta after
    NSTEPS steps of DT from 0, with setup, first-call and per-step times."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.models import bioheat

    t0 = time.perf_counter()
    op = bioheat.BioheatOperator(
        fes=fes, rho_c=RHO_C, k=K_TH, w_cb=W_CB, T_a=T_A, q_met=src,
        ess_bdr=ess_bdr, rel_tol=rel_tol, max_iter=300, dtype=dtype,
        fused_setup=True, theta_form=True, **kw)
    jax.block_until_ready(op.b_const)
    setup_s = time.perf_counter() - t0
    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    th = jnp.zeros(fes.ndof, jnp.dtype(dtype))
    t, dt = jnp.asarray(0.0, th.dtype), jnp.asarray(DT, th.dtype)
    t0 = time.perf_counter()
    th, t = step(th, t, dt)
    jax.block_until_ready(th)
    first_s = time.perf_counter() - t0
    for _ in range(NSTEPS - 1):
        th, t = step(th, t, dt)
    theta = np.asarray(th)
    out = {"op": op, "theta": theta, "setup_s": setup_s,
           "first_step_s": first_s}
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            th, t = step(th, t, dt)
        jax.block_until_ready(th)
        out["step_s"] = (time.perf_counter() - t0) / timed
        # the first call = compile + one step
        out["compile_s"] = first_s - out["step_s"]
    return out


def time_call(f, *args, reps=20):
    """Seconds per call of jitted ``f`` after a warm-up call."""
    import jax

    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def restriction_round_trip(gather_map, ndof):
    """Seconds and logical bytes/s of the base ElementRestriction's L→E→L
    round trip in f32, and of an unsorted ``.at[].add`` scatter as a
    comparison candidate (non-deterministic on the GPU: atomics)."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.restriction import ElementRestriction

    r = ElementRestriction.from_map(np.asarray(gather_map), ndof)
    ne, nd = r.gather.shape
    u = jnp.asarray(np.random.default_rng(0).standard_normal(ndof),
                    jnp.float32)
    rt = jax.jit(lambda v, r: r.mult_transpose_t(r.mult_t(v)))
    sc = jax.jit(lambda v, g: jnp.zeros(ndof, v.dtype).at[g].add(v[g]))
    # logical bytes: L→E reads the map and the gathered values and writes
    # E; E→L reads the permutation, the permuted E values and the segment
    # ids and writes L (4 bytes each).  The scatter: map, values, E, L.
    nb_rt = 4.0 * (6 * ne * nd + ndof)
    nb_sc = 4.0 * (3 * ne * nd + ndof)
    t_rt = time_call(rt, u, r)
    t_sc = time_call(sc, u, r.gather)
    return {"ne": ne, "nd": nd, "ndof": ndof,
            "round_trip_s": t_rt, "round_trip_GBps": nb_rt / t_rt / 1e9,
            "at_add_scatter_s": t_sc,
            "at_add_scatter_GBps": nb_sc / t_sc / 1e9}


# ----------------------------------------------------------------------
# the host reference: scipy matrices, numpy SDIRK33, float64
# ----------------------------------------------------------------------

def host_matrices(fes):
    """(M_rhoc, K_k, M_w) as scipy CSR in f64, assembled on the CPU."""
    import jax

    from cardiac_ablation_ecm2.ops.bilinearform import BilinearForm

    with jax.default_device(jax.devices("cpu")[0]):
        def asm(kind, c):
            return BilinearForm(fes).add_domain_integrator(
                kind, c).assemble_matrix("float64").tocsr()

        return asm("mass", RHO_C), asm("diffusion", K_TH), asm("mass", W_CB)


def host_load(fes, src):
    """(src, v) in f64 with numpy: Σ_e Bᵀ (w·detJ·src(x_q)) scattered by
    the space's gather map, at the operator's quadrature rule."""
    import jax

    from cardiac_ablation_ecm2.fem.build import geom_factors_for

    with jax.default_device(jax.devices("cpu")[0]):
        gf = geom_factors_for(fes, dtype="float64")
        xq = np.asarray(gf.x, np.float64)
        wdet = np.asarray(gf.wdet, np.float64)
    B = np.asarray(fes.dof_to_quad().full_B(), np.float64)   # (nq, nd)
    fe = (wdet * src(xq)) @ B                                # (ne, nd)
    F = np.zeros(fes.ndof)
    np.add.at(F, np.asarray(fes.gather_map).reshape(-1), fe.reshape(-1))
    return F


def _pcg(A, b, diag, rtol, maxiter=5000):
    """Jacobi-PCG to ||r||₂ ≤ rtol·||b||₂ (numpy; independent of
    linalg/solvers.py)."""
    x = np.zeros_like(b)
    r = b.copy()
    nb = np.linalg.norm(b)
    if nb == 0.0:
        return x
    z = r / diag
    p = z.copy()
    rz = r @ z
    for _ in range(maxiter):
        Ap = A @ p
        alpha = rz / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        if np.linalg.norm(r) <= rtol * nb:
            return x
        z = r / diag
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError("host reference PCG did not converge")


def host_reference(fes, src, ess, mats=None, rtol=1e-12):
    """theta after NSTEPS SDIRK33 steps of DT: (M + γA) k = b_θ − A y with
    k = 0 on ``ess`` (rows and columns eliminated), A = K + M_w,
    b_θ = (src, v) − K·T_a (theta form)."""
    M, K, Mw = mats if mats is not None else host_matrices(fes)
    A = (K + Mw).tocsr()
    b = host_load(fes, src) - K @ np.full(fes.ndof, T_A)
    free = np.setdiff1d(np.arange(fes.ndof), np.asarray(ess))
    Mf, Af = M[free][:, free], A[free][:, free]
    theta = np.zeros(fes.ndof)
    for _ in range(NSTEPS):
        ks = []
        for i in range(3):
            y = theta + DT * sum(SDIRK33_A[i][j] * ks[j] for j in range(i))
            gam = SDIRK33_A[i][i] * DT
            S = (Mf + gam * Af).tocsr()
            k = np.zeros(fes.ndof)
            k[free] = _pcg(S, (b - A @ y)[free], S.diagonal(), rtol)
            ks.append(k)
        theta = theta + DT * sum(bi * ki for bi, ki in zip(SDIRK33_B, ks))
    return theta


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_lattice(n=48, n_ref=16):
    """48³ order-2 hex lattice on the structured path, as bench.py runs it;
    checked against the same run in f64 on the card and, at ``n_ref``,
    against the host f64 reference."""
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d

    def space(m):
        return CartesianFESpace(make_cartesian_3d(m, m, m, L, L, L), ORDER,
                                (m, m, m), (L, L, L))

    kw = dict(src=LATTICE_SRC, collapse_uniform_qdata=True)
    ck = Checks()
    fes = space(n)
    r32 = run_bioheat(fes, dtype="float32", rel_tol=1e-5, timed=TIMED_STEPS,
                      **kw)
    r64 = run_bioheat(fes, dtype="float64", rel_tol=1e-5, **kw)
    tmax32, tmax64 = r32["theta"].max(), r64["theta"].max()
    ck.le("theta_max f32 vs f64 (rel)", _rel(tmax32, tmax64), TOL_F32_VS_F64)
    out = {"phase": "lattice", "path": "structured", "n": n,
           "ne": fes.mesh.ne, "ndof": fes.ndof, "theta_max": float(tmax32),
           "theta_max_f64": float(tmax64)}
    out["f32_field_err_vs_f64"] = _field_err(r32["theta"], r64["theta"])
    del r64

    # the same lattice through the generic gather/segment-sum restriction
    gen = FESpace(fes.mesh, ORDER)
    out["restriction_generic_lattice"] = restriction_round_trip(
        gen.gather_map, gen.ndof_scalar)
    del gen

    fr = space(n_ref)
    ess = fr.essential_dofs(ESS_ALL)
    ref = host_reference(fr, LATTICE_SRC, ess)
    s32 = run_bioheat(fr, dtype="float32", rel_tol=1e-5, **kw)["theta"]
    s64 = run_bioheat(fr, dtype="float64", rel_tol=1e-12, **kw)["theta"]
    ck.le(f"{n_ref}^3 f32 field vs host f64", _field_err(s32, ref),
          TOL_LATTICE_F32_VS_HOST)
    ck.le(f"{n_ref}^3 f64 field vs host f64", _field_err(s64, ref),
          TOL_F64_VS_HOST)
    ck.true("finite", np.isfinite(r32["theta"]).all())
    out.update(setup_s=r32["setup_s"], compile_s=r32["compile_s"],
               step_s=r32["step_s"], ref_n=n_ref, ref_ndof=fr.ndof,
               ref_theta_max=float(ref.max()))
    return out, ck


def phase_cardiac_tet(ctx, n=48):
    """Unstructured cardiac tets on the generic FESpace path (base
    ElementRestriction), f32 — MFEM's theta_max, the host f64 reference and
    an f64 run on the card."""
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_tet_mesh

    ck = Checks()
    t0 = time.perf_counter()
    mesh = make_cardiac_tet_mesh(n, lengths=(L, L, L / 2),
                                 electrode_radius=0.004)
    fes = FESpace(mesh, ORDER)
    mesh_s = time.perf_counter() - t0
    rec = _baseline_row("cardiac-tet", n)
    if rec is not None:
        ck.true("ne == MFEM record", mesh.ne == rec["ne"], mesh.ne)
        ck.true("ndof == MFEM record", fes.ndof == rec["ndof"], fes.ndof)
    r32 = run_bioheat(fes, CARDIAC_SRC, dtype="float32", rel_tol=1e-5,
                      timed=TIMED_STEPS)
    tmax = float(r32["theta"].max())
    if rec is not None:
        ck.le("theta_max vs MFEM (rel)", _rel(tmax, rec["theta_max"]),
              TOL_VS_MFEM)
    mats = host_matrices(fes)
    ess = fes.essential_dofs(ESS_ALL)
    ref = host_reference(fes, CARDIAC_SRC, ess, mats)
    r64 = run_bioheat(fes, CARDIAC_SRC, dtype="float64", rel_tol=1e-12)
    ck.le("f32 field vs host f64", _field_err(r32["theta"], ref),
          TOL_TET_F32_VS_HOST)
    ck.le("f64 field vs host f64", _field_err(r64["theta"], ref),
          TOL_F64_VS_HOST)
    ck.true("finite", np.isfinite(r32["theta"]).all())
    theta_pa64 = r64["theta"]
    del r64

    import jax
    import jax.numpy as jnp

    op = r32["op"]
    gamma = jnp.float32(_G * DT)
    v = jnp.asarray(np.random.default_rng(1).standard_normal(fes.ndof),
                    jnp.float32)
    pa_apply_s = time_call(
        jax.jit(lambda v, g: op._implicit_lhs_apply(g, v)), v, gamma)
    ctx.update(fes=fes, mats=mats, ref=ref, mfem=rec, theta_pa=r32["theta"],
               theta_pa64=theta_pa64, v=v, gamma=gamma, pa_apply_s=pa_apply_s)
    out = {"phase": "cardiac_tet", "path": "generic", "n": n, "ne": mesh.ne,
           "ndof": fes.ndof, "theta_max": tmax,
           "mfem_theta_max": rec["theta_max"] if rec else None,
           "host_ref_theta_max": float(ref.max()), "mesh_s": mesh_s,
           "setup_s": r32["setup_s"], "compile_s": r32["compile_s"],
           "step_s": r32["step_s"], "pa_lhs_apply_s": pa_apply_s,
           "restriction": restriction_round_trip(fes.gather_map,
                                                 fes.ndof_scalar)}
    return out, ck


def phase_cardiac_tet_ell(ctx):
    """The same mesh through the assembled multi-ELL pair: the timed f32
    run against MFEM's theta_max (PA's bound), and the operator against PA
    with both in f64 at rel_tol 1e-12, where CG truncation no longer
    separates them."""
    import jax

    ck = Checks()
    fes = ctx["fes"]
    r = run_bioheat(fes, CARDIAC_SRC, dtype="float32", rel_tol=1e-5,
                    timed=TIMED_STEPS, assembled_apply="ell")
    rec = ctx["mfem"]
    if rec is not None:
        ck.le("theta_max vs MFEM (rel)",
              _rel(r["theta"].max(), rec["theta_max"]), TOL_VS_MFEM)
    r64 = run_bioheat(fes, CARDIAC_SRC, dtype="float64", rel_tol=1e-12,
                      assembled_apply="ell")
    ck.le("f64 field vs PA f64", _field_err(r64["theta"], ctx["theta_pa64"]),
          TOL_ELL_VS_PA)
    del r64
    M, K, Mw = ctx["mats"]
    ell = r["op"]._ell
    x = np.asarray(ctx["v"], np.float64)
    g = float(ctx["gamma"])
    y_ref = M @ x + g * ((K + Mw) @ x)
    y = np.asarray(ell.mult_combined(ctx["v"], 1.0, ctx["gamma"]))
    ck.le("ELL pair (M + gamma A) x vs scipy f64 (rel)",
          np.max(np.abs(y - y_ref)) / np.max(np.abs(y_ref)),
          TOL_ELL_VS_SCIPY)
    ck.true("finite", np.isfinite(r["theta"]).all())
    ell_s = time_call(jax.jit(lambda v, g, e: e.mult_combined(v, 1.0, g)),
                      ctx["v"], ctx["gamma"], ell)
    nnz = sum(int(c.size) for c, _ in ell.buckets)
    return {"phase": "cardiac_tet_ell", "path": "assembled-ell",
            "ne": fes.mesh.ne, "ndof": fes.ndof,
            "theta_max": float(r["theta"].max()), "ell_slots": nnz,
            # informational: f32 solves truncated at rel_tol 1e-5
            "f32_field_diff_vs_pa": _field_err(r["theta"], ctx["theta_pa"]),
            "f32_field_err_vs_host": _field_err(r["theta"], ctx["ref"]),
            "setup_s": r["setup_s"], "compile_s": r["compile_s"],
            "step_s": r["step_s"], "ell_apply_s": ell_s,
            "pa_lhs_apply_s": ctx["pa_apply_s"],
            # f32 vals + int32 cols per slot, x read and y written
            "ell_apply_logical_GBps":
                (8.0 * nnz + 8.0 * fes.ndof) / ell_s / 1e9}, ck


def phase_cardiac_hex_masked(n=126):
    """The ~1M-element carved cardiac hex deployment on the masked-lattice
    path (bench.py BENCH_MESH=cardiac-hex BENCH_STRUCTURED=1)."""
    from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2.fem.masked_lattice import (
        masked_lattice_active_count,
        masked_lattice_essential,
    )
    from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_hex_lattice

    ck = Checks()
    t0 = time.perf_counter()
    mesh, keep, ns = make_cardiac_hex_lattice(
        n, lengths=(L, L, L / 2), electrode_radius=0.004)
    fes = CartesianFESpace(mesh, ORDER, ns, (L, L, L / 2))
    ess = masked_lattice_essential(ns, ORDER, keep)
    ndof_active = masked_lattice_active_count(ns, ORDER, keep)
    mesh_s = time.perf_counter() - t0
    ne_active = int(keep.sum())
    rec = _baseline_row("cardiac-hex", n)
    if rec is not None:
        ck.true("active ne == MFEM record", ne_active == rec["ne"], ne_active)
        ck.true("active ndof == MFEM record", ndof_active == rec["ndof"],
                ndof_active)
    r = run_bioheat(fes, CARDIAC_SRC, dtype="float32", rel_tol=1e-5,
                    ess_bdr=None, elem_mask=keep.astype(np.float32),
                    ess_dofs=ess, timed=TIMED_STEPS)
    tmax = float(r["theta"].max())
    if rec is not None:
        ck.le("theta_max vs MFEM (rel)", _rel(tmax, rec["theta_max"]),
              TOL_VS_MFEM)
    ck.true("finite", np.isfinite(r["theta"]).all())
    return {"phase": "cardiac_hex_masked", "path": "masked-structured",
            "n": n, "ne": ne_active, "ndof": ndof_active,
            "lattice_ndof": fes.ndof, "theta_max": tmax,
            "mfem_theta_max": rec["theta_max"] if rec else None,
            "mesh_s": mesh_s, "setup_s": r["setup_s"],
            "compile_s": r["compile_s"], "step_s": r["step_s"]}, ck


#: ablation run: 20 mm block, electrode on the top face (attribute 6),
#: ground on the bottom (1), side faces held at T_a, σ(T) re-solved every
#: 2 steps — 8 steps of 0.5 s.
ABL_STEPS, ABL_DT, ABL_VOLTAGE, ABL_SIZE = 8, 0.5, 150.0, 0.02


def _ablation(n, dtype, rel_tol):
    """(sim, T, omega, seconds): setup; a 2-step warm-up run that compiles
    every piece; then the full ABL_STEPS run from the initial state."""
    import jax

    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.models import ablation

    s = ABL_SIZE
    t0 = time.perf_counter()
    sim = ablation.AblationSim(
        mesh=make_cartesian_3d(n, n, n, s, s, s), order=ORDER,
        voltage=ABL_VOLTAGE, sigma=0.54, electrode_bdr=[6], ground_bdr=[1],
        body_bdr=[2, 3, 4, 5], resolve_every=2,
        sigma_T=lambda Tq: 0.54 * (1.0 + 0.015 * (Tq - 37.0)),
        dtype=dtype, rel_tol=rel_tol)
    jax.block_until_ready(sim.rf.phi)
    times = {"setup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    jax.block_until_ready(sim.run(2 * ABL_DT, ABL_DT)[0])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    T, om, _ = sim.run(ABL_STEPS * ABL_DT, ABL_DT)
    jax.block_until_ready(T)
    # whole coupled run, RF re-solves included, per step
    times["step_s"] = (time.perf_counter() - t0) / ABL_STEPS
    times["compile_s"] = warm_s - 2 * times["step_s"]
    return sim, np.asarray(T), np.asarray(om), times


def phase_ablation(n=24):
    """AblationSim as examples/ablation_demo.py builds it: RF Laplace → SAR
    → bioheat → Arrhenius with σ(T) re-solves, f32 vs f64 on the card."""
    ck = Checks()
    sim, T32, om32, times = _ablation(n, "float32", 1e-6)
    sim64, T64, om64, _ = _ablation(n, "float64", 1e-10)
    vol32, vol64 = sim.lesion_volume(om32), sim64.lesion_volume(om64)
    th32, th64 = T32.max() - T_A, T64.max() - T_A
    ck.true("finite", np.isfinite(T32).all() and np.isfinite(om32).all())
    ck.true("lesion volume > 0", vol32 > 0.0, vol32)
    ck.le("theta_max f32 vs f64 (rel)", _rel(th32, th64), TOL_ABLATION)
    ck.le("lesion volume f32 vs f64 (rel)", _rel(vol32, vol64)
          if vol64 > 0 else math.inf, TOL_ABLATION)
    return {"phase": "ablation", "n": n, "ne": sim.mesh.ne,
            "ndof": sim.fes.ndof, "steps": ABL_STEPS, "dt": ABL_DT,
            "theta_max": float(th32), "theta_max_f64": float(th64),
            "lesion_m3": vol32, "lesion_m3_f64": vol64,
            "rf_cg_iters": sim.rf.iterations, **times}, ck


def collective_seconds(trace_dir):
    """Seconds of collective kernels (NCCL / all-reduce / collective-permute
    events) per GPU plane in the newest profiler trace under
    ``trace_dir``: the largest per-line sum on each device plane."""
    import glob

    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        return {}
    keys = ("nccl", "all-reduce", "allreduce", "collective-permute",
            "all-gather", "reduce-scatter", "sendrecv")
    per_dev = {}
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        best = 0.0
        for line in plane.lines:
            tot = sum(ev.duration_ns for ev in line.events
                      if any(k in ev.name.lower() for k in keys))
            best = max(best, tot * 1e-9)
        per_dev[plane.name] = best
    return per_dev


def phase_four_cards(n=66, ndev=4, trace_dir=None):
    """The ~1M-element cardiac tet mesh sharded over ``ndev`` devices with
    halo exchange (parallel.bioheat.setup), f64, against the one-card
    BioheatOperator step on the same mesh and MFEM's theta_max."""
    import jax
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_tet_mesh
    from cardiac_ablation_ecm2.parallel import bioheat as pbio

    ck = Checks()
    devices = jax.devices()[:ndev]
    ck.true(f"{ndev} devices", len(devices) == ndev, len(devices))
    t0 = time.perf_counter()
    mesh = make_cardiac_tet_mesh(n, lengths=(L, L, L / 2),
                                 electrode_radius=0.004)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = pbio.setup(mesh, order=ORDER, ndev=ndev, rho_c=RHO_C, k=K_TH,
                     w_cb=W_CB, T_a=T_A, q_src=CARDIAC_SRC, ess_bdr=ESS_ALL,
                     solver="sdirk33", rel_tol=1e-5, max_iter=300,
                     dtype="float64", devices=devices)
    setup_s = time.perf_counter() - t0
    T, t = sim.T0, 0.0
    t0 = time.perf_counter()
    T, t = sim.step(T, t, DT)
    jax.block_until_ready(T)
    first_s = time.perf_counter() - t0
    placed = {s.device for s in T.addressable_shards}
    ck.true("one shard on each device", placed == set(devices),
            sorted(str(d) for d in placed))
    for _ in range(NSTEPS - 1):
        T, t = sim.step(T, t, DT)
    theta4 = sim.gather(T) - T_A
    t0 = time.perf_counter()
    Tt, tt = T, t
    for _ in range(TIMED_STEPS):
        Tt, tt = sim.step(Tt, tt, DT)
    jax.block_until_ready(Tt)
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    coll = {}
    if trace_dir is not None:
        with jax.profiler.trace(trace_dir):
            for _ in range(2):
                Tt, tt = sim.step(Tt, tt, DT)
            jax.block_until_ready(Tt)
        coll = {k: v / 2 for k, v in collective_seconds(trace_dir).items()}
    del sim, T, Tt

    with jax.default_device(devices[0]):
        r1 = run_bioheat(FESpace(mesh, ORDER), CARDIAC_SRC,
                         dtype="float64", rel_tol=1e-5,
                         timed=TIMED_STEPS)
    theta1 = r1["theta"]
    ck.le("sharded field vs one card (max-abs / theta_max)",
          _field_err(theta4, theta1), TOL_SHARDED)
    rec = _baseline_row("cardiac-tet", n)
    if rec is not None:
        ck.true("ne == MFEM record", mesh.ne == rec["ne"], mesh.ne)
        ck.true("ndof == MFEM record", theta4.size == rec["ndof"],
                theta4.size)
        ck.le("theta_max vs MFEM (rel)",
              _rel(theta4.max(), rec["theta_max"]), TOL_VS_MFEM)
    ck.true("finite", np.isfinite(theta4).all())
    return {"phase": "four_cards", "path": "sharded-generic", "n": n,
            "ndev": ndev, "ne": mesh.ne, "ndof": int(theta4.size),
            "dtype": "float64", "theta_max": float(theta4.max()),
            "mfem_theta_max": rec["theta_max"] if rec else None,
            "mesh_s": mesh_s, "setup_s": setup_s,
            "compile_s": first_s - step_s, "step_s": step_s,
            "collective_s_per_step": coll,
            "one_card_step_s": r1["step_s"],
            "one_card_setup_s": r1["setup_s"]}, ck


# ----------------------------------------------------------------------

def _run_phase(name, fn, *args, **kw):
    """Run one phase; print its JSON line; return whether it passed."""
    import gc

    t0 = time.perf_counter()
    try:
        out, ck = fn(*args, **kw)
    except Exception:
        traceback.print_exc()
        print(json.dumps({"phase": name, "ok": False, "error":
                          traceback.format_exc().splitlines()[-1]}),
              flush=True)
        return False
    out.update(ok=ck.ok, checks=ck.items, wall_s=time.perf_counter() - t0,
               peak_bytes_in_use=_peak_bytes())
    print(json.dumps(out, default=float), flush=True)
    gc.collect()
    return ck.ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded four-card phase")
    args = ap.parse_args(argv)

    import jax

    from cardiac_ablation_ecm2.utils.config import (
        configure,
        enable_compilation_cache,
    )
    from cardiac_ablation_ecm2.utils.device import (
        NoGPUError,
        card_name_and_power_limit,
        require_gpu,
    )

    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    # bench.py's configuration: p+1 Gauss points per direction, true-f32
    # contractions
    configure(quad_extra=0, matmul_precision="highest")
    card = card_name_and_power_limit()
    print(json.dumps({"device_kind": device["kind"],
                      "device_count": device["count"],
                      "jax": jax.__version__, "card": card}), flush=True)

    ok = True
    if args.four_cards:
        if device["count"] < 4:
            print("chip_smoke.py: --four-cards needs 4 GPUs, found "
                  f"{device['count']}", file=sys.stderr)
            return 2
        import tempfile

        with tempfile.TemporaryDirectory() as trace:
            ok = _run_phase("four_cards", phase_four_cards, trace_dir=trace)
    else:
        ctx = {}
        ok &= _run_phase("lattice", phase_lattice)
        ok &= _run_phase("cardiac_tet", phase_cardiac_tet, ctx)
        if ctx:
            ok &= _run_phase("cardiac_tet_ell", phase_cardiac_tet_ell, ctx)
        else:
            ok = False
        ctx.clear()
        ok &= _run_phase("cardiac_hex_masked", phase_cardiac_hex_masked)
        ok &= _run_phase("ablation", phase_ablation)
    if not ok:
        print("chip_smoke.py: a phase failed", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
