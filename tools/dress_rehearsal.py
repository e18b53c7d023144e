"""Config-5 dress rehearsal at scale (VERDICT r2 item 7).

Compile-and-one-step of the SHARDED bioheat step at ≥1M elements on 8
virtual CPU devices — wall-clock is irrelevant; the point is to flush
shape/memory surprises in the production sharding (halo tables, padded
local slabs, psum dots) at the BASELINE config-5 scale rather than at the
32-element dryrun size.

Usage:  python tools/dress_rehearsal.py [--n 101] [--ndev 8] [--structured]
Prints one JSON line per rehearsal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=101,
                    help="elements per axis (n^3 >= 1e6 at 101)")
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--structured", action="store_true",
                    help="run the Cartesian sharded path instead of the "
                         "generic one")
    ap.add_argument("--cardiac-tet", action="store_true",
                    help="rehearse on the REAL unstructured cardiac tet "
                         "mesh (mesh/cardiac.py) instead of the lattice; "
                         "--n is the cardiac resolution (66 ≈ 957k tets)")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.ndev}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    # persistent executable cache: repeat rehearsals of the unchanged step
    # skip the multi-minute compile
    from cardiac_ablation_ecm2.utils.config import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp
    import numpy as np

    from cardiac_ablation_ecm2.mesh import make_cartesian_3d

    n = args.n
    L = 0.04
    if args.cardiac_tet:
        from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_tet_mesh

        mesh = make_cardiac_tet_mesh(n, lengths=(L, L, L / 2),
                                     electrode_radius=0.004)
    else:
        mesh = make_cartesian_3d(n, n, n, L, L, L)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 1e6 * jnp.exp(-r2 / (L / 8) ** 2)

    devices = jax.devices("cpu")[: args.ndev]
    t0 = time.time()
    if args.structured:
        from cardiac_ablation_ecm2.parallel import cartesian_bioheat as pb

        sim = pb.setup(
            n, n, n, order=args.order, ndev=args.ndev, lengths=(L, L, L),
            q_src=src, solver="sdirk33",
            rel_tol=1e-6, max_iter=50, devices=devices,
        )
    else:
        from cardiac_ablation_ecm2.parallel import bioheat as pb

        sim = pb.setup(
            mesh, order=args.order, ndev=args.ndev, q_src=src,
            ess_bdr=[1, 2, 3, 4, 5, 6], solver="sdirk33",
            rel_tol=1e-6, max_iter=50, devices=devices,
        )
    setup_s = time.time() - t0

    t0 = time.time()
    T, t = sim.step(sim.T0, 0.0, 0.25)
    jax.block_until_ready(T)
    step_s = time.time() - t0
    # compile vs execute split: a SECOND step hits the in-process executable
    # cache, so its wall time is pure execution; compile ≈ first − second.
    t0 = time.time()
    T2, _ = sim.step(T, 0.25, 0.25)
    jax.block_until_ready(T2)
    exec_s = time.time() - t0
    out = sim.gather(T)
    ok = bool(np.isfinite(out).all())
    print(json.dumps({
        "rehearsal": ("cardiac-tet" if args.cardiac_tet else
                      "structured" if args.structured else "generic"),
        "ne": mesh.ne, "order": args.order, "ndev": args.ndev,
        "ndof": int(out.size), "setup_s": round(setup_s, 1),
        "exec_step_s": round(exec_s, 1),
        "compile_s": round(step_s - exec_s, 1),
        "compile_plus_step_s": round(step_s, 1),
        "finite": ok, "T_rise_max": float(np.max(out) - 37.0)
        if ok else None,
    }), flush=True)
    assert ok


if __name__ == "__main__":
    main()
