"""Benchmark driver: implicit Pennes-bioheat timestep throughput.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric (BASELINE.md): wall-clock per implicit SDIRK33 bioheat timestep on a
3D hex mesh, reported as DOF/s per GPU.  ``vs_baseline`` compares against the
measured MFEM CPU reference (``bench_baseline.json``) — values > 1 mean
faster than the reference CPU baseline.

Runs only on a GPU: without one it exits non-zero.  The step is timed with
``block_until_ready`` around a loop of warm steps (the first step compiles).

Environment knobs: BENCH_N (elements/axis, default 48), BENCH_ORDER (2),
BENCH_STEPS (5), BENCH_DTYPE (float32).
"""

from __future__ import annotations

import json
import os
import sys
import time


def main():
    n = int(os.environ.get("BENCH_N", "48"))
    order = int(os.environ.get("BENCH_ORDER", "2"))
    steps = int(os.environ.get("BENCH_STEPS", "5"))
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    tol = float(os.environ.get("BENCH_TOL", "1e-5"))

    import jax

    from cardiac_ablation_ecm2.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()

    # enable x64 so mixed-precision CG can accumulate inner products in f64
    # (the convergence criterion (r,z) <= rel^2 (r0,z0) is unevaluable in
    # pure f32; arrays stay float32 — only the dot reductions widen)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.models import bioheat
    from cardiac_ablation_ecm2.utils.config import (
        configure,
        enable_compilation_cache,
    )

    # quad_extra=0 → nq1d = p+1 Gauss: EXACT for the affine-hex constant-
    # coefficient operator (integrand degree ≤ 2p per direction; 3-pt Gauss
    # is order-5) and matches MFEM's own default 2p-order rule — while
    # carrying 27 instead of 64 qdata points per element (2.4× less HBM
    # traffic on the dominant stream).
    configure(dtype=dtype,
              matmul_precision=os.environ.get("BENCH_MATMUL", "highest"),
              quad_extra=int(os.environ.get("BENCH_QUAD_EXTRA", "0")))

    # persistent XLA executable cache: re-runs of the same step skip the
    # compile
    enable_compilation_cache()

    L = 0.04
    # BENCH_MESH: "cartesian" (default), "cardiac-tet" (genuinely
    # unstructured Delaunay tets + electrode notch), "cardiac-hex"
    # (warped/jittered hexes + notch) — the BASELINE config-5 workload on a
    # real mesh (mesh/cardiac.py); identical files feed the MFEM CPU driver
    # (tools/mfem_bioheat_bench.cpp).
    mesh_kind = os.environ.get("BENCH_MESH", "cartesian")
    cardiac = mesh_kind.startswith("cardiac")
    unstructured = cardiac or os.environ.get("BENCH_UNSTRUCTURED", "0") == "1"
    # BENCH_STRUCTURED=1 + cardiac-hex: the masked-lattice fast path — the
    # carved hex problem on the FULL lattice's gather-free CartesianFESpace
    # with zeroed notch elements + pinned carved dofs.  Equivalent to the
    # carved mesh by construction (tests/test_masked_lattice.py: 1e-8).
    masked = (mesh_kind == "cardiac-hex"
              and os.environ.get("BENCH_STRUCTURED", "0") == "1")
    elem_mask = ess_extra = None
    ndof_active = None
    if masked:
        import numpy as np

        from cardiac_ablation_ecm2.fem.masked_lattice import (
            masked_lattice_active_count,
            masked_lattice_essential,
        )
        from cardiac_ablation_ecm2.mesh.cardiac import (
            make_cardiac_hex_lattice,
        )

        mesh, keep, ns = make_cardiac_hex_lattice(
            n, lengths=(L, L, L / 2), electrode_radius=0.004)
        fes = CartesianFESpace(mesh, order, ns, (L, L, L / 2))
        elem_mask = keep.astype(np.float32)
        ess_extra = masked_lattice_essential(ns, order, keep)
        ndof_active = masked_lattice_active_count(ns, order, keep)
        unstructured = False
    elif mesh_kind == "cardiac-tet":
        from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_tet_mesh

        mesh = make_cardiac_tet_mesh(n, lengths=(L, L, L / 2),
                                     electrode_radius=0.004)
    elif mesh_kind == "cardiac-hex":
        from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_hex_mesh

        mesh = make_cardiac_hex_mesh(n, lengths=(L, L, L / 2),
                                     electrode_radius=0.004)
    else:
        mesh = make_cartesian_3d(n, n, n, L, L, L)
    if masked:
        pass
    elif unstructured:
        # generic unstructured path: entity-key dof numbering + gather /
        # segment-sum restriction (the path a real cardiac mesh takes)
        from cardiac_ablation_ecm2.fem import FESpace

        fes = FESpace(mesh, order)
    else:
        # structured Cartesian space: gather-free restriction (fast path)
        fes = CartesianFESpace(mesh, order, (n, n, n), (L, L, L))

    # lattice: broad metabolic-style Gaussian; cardiac: SAR source at the
    # electrode tip (mesh/cardiac.py)
    ctr = (L / 2, L / 2, L / 2)
    amp, width2 = ((2e7, 2 * 0.003**2) if cardiac
                   else (1e6, (L / 8) ** 2))

    def src(x):
        r2 = sum((x[..., i] - ctr[i]) ** 2 for i in range(3))
        return amp * jnp.exp(-r2 / width2)

    op = bioheat.BioheatOperator(
        fes=fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, q_met=src,
        ess_bdr=None if masked else [1, 2, 3, 4, 5, 6],
        elem_mask=elem_mask, ess_dofs=ess_extra,
        rel_tol=tol, max_iter=300,
        dtype=dtype, fused_setup=True, theta_form=True,
        qdata_bf16=os.environ.get("BENCH_BF16_QDATA", "0") == "1",
        cg_variant=os.environ.get("BENCH_CG", "classic"),
        # BENCH_ELL=1: assembled multi-ELL apply instead of the matrix-free
        # PA pipeline (ops/ell.py)
        assembled_apply=("ell" if os.environ.get("BENCH_ELL", "0")
                         == "1" else "off"),
        collapse_uniform_qdata=(
            not unstructured and not masked
            and os.environ.get("BENCH_NO_COLLAPSE", "0") != "1"),
    )
    solver = ode.select("sdirk33")

    # big operator arrays ride as jit ARGUMENTS (models/bioheat.big_arrays)
    step = bioheat.make_stepper(op, solver)

    # theta form: state is the temperature rise (starts at 0)
    T = jnp.zeros(fes.ndof, dtype=jnp.dtype(dtype))
    t, dt = jnp.asarray(0.0, T.dtype), jnp.asarray(0.25, T.dtype)

    # warm-up step compiles; then `steps` chained steps, one sync at the end
    t0 = time.perf_counter()
    Tc, tc = step(T, t, dt)
    jax.block_until_ready(Tc)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        Tc, tc = step(Tc, tc, dt)
    jax.block_until_ready(Tc)
    per_step = (time.perf_counter() - t0) / steps
    if not bool(jnp.all(jnp.isfinite(Tc))):
        raise FloatingPointError("non-finite temperature after the timed steps")
    # masked-lattice path: report the CARVED problem's dof count (what the
    # MFEM baseline solves), not the full lattice's (which also numbers the
    # pinned notch interior)
    ndof_eff = ndof_active if ndof_active is not None else fes.ndof
    dofs_per_s = ndof_eff / per_step

    baseline = None
    try:
        with open(os.path.join(os.path.dirname(__file__), "bench_baseline.json")) as f:
            bj = json.load(f)
        if cardiac:
            rows = [r for r in bj.get("cardiac", []) if r.get("mesh") == mesh_kind]
        else:
            rows = [bj["config"] | {"seconds_per_step": bj["mfem_cpu_seconds_per_step"]}]
            rows += bj.get("also_measured", [])
        match = [r for r in rows if r.get("n") == n]
        if match:
            baseline = match[0]["seconds_per_step"]
        elif rows:
            # scale the headline row by dof count (throughput is ~flat on CPU)
            r0 = rows[0]
            baseline = r0["seconds_per_step"] * ndof_eff / r0.get("ndof", ndof_eff)
    except (OSError, KeyError, ValueError):
        pass
    vs = (baseline / per_step) if baseline else 0.0

    return {
        "metric": "bioheat_implicit_timestep_dofs_per_s_per_chip",
        "value": dofs_per_s,
        "unit": "DOF/s",
        "vs_baseline": vs,
        "device": device,
        "card": card_name_and_power_limit(),
        "extra": {
            "seconds_per_step": per_step,
            "first_step_seconds_incl_compile": compile_s,
            "ndof": ndof_eff,
            "ne": mesh.ne,
            "order": order,
            "dtype": dtype,
            "solver": "sdirk33+pcg(jacobi)", "rel_tol": tol,
            "path": ("masked-structured" if masked else
                     "unstructured" if unstructured else "structured"),
            "mesh": mesh_kind,
        },
    }


if __name__ == "__main__":
    from cardiac_ablation_ecm2.utils.device import NoGPUError

    try:
        result = main()
    except NoGPUError as e:
        sys.exit(f"bench.py: {e}")
    print(json.dumps(result))
