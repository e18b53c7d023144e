"""CEED BP-style benchmarks: BP1 (mass) / BP3 (diffusion) CG throughput.

Reference analog: ``tests/benchmarks/bench_assembly_levels.cpp:173-194`` —
MDof/s = dofs × CG iterations / solve seconds, per order and assembly level.

Usage: python benchmarks/bp.py [--orders 1,2,3,4] [--n 32] [--dtype float32]
Prints one JSON line per (bp, order).  Runs on the GPU and exits non-zero
without one; ``--cpu`` runs on the CPU backend as a rehearsal only (its
times are not device measurements).
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
    ap.add_argument("--orders", default="1,2,3,4")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend (no device timing)")
    ap.add_argument("--structured", action="store_true",
                    help="use the Cartesian gather-free fast path")
    ap.add_argument("--simplex", action="store_true",
                    help="tet mesh (non-tensor basis, lane-major full-matrix apply)")
    ap.add_argument("--ell", action="store_true",
                    help="assembled ELL weighted-gather SpMV "
                         "(ops/ell.py)")
    args = ap.parse_args()

    import jax

    from cardiac_ablation_ecm2.utils.device import (
        card_name_and_power_limit,
        require_gpu,
    )

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        dev = jax.devices()
        device = {"platform": dev[0].platform, "kind": dev[0].device_kind,
                  "count": len(dev), "rehearsal": True}
        card = None
    else:
        device = require_gpu()
        card = card_name_and_power_limit()
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.linalg.smoothers import jacobi
    from cardiac_ablation_ecm2.mesh import (
        make_cartesian_3d,
        make_cartesian_3d_tet,
    )
    from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator
    from cardiac_ablation_ecm2.utils.config import configure

    configure(dtype=args.dtype)

    for order in [int(o) for o in args.orders.split(",")]:
        # keep dof count roughly constant across orders
        n = max(2, args.n // order)
        if args.simplex:
            mesh = make_cartesian_3d_tet(n, n, n)
            fes = FESpace(mesh, order)
        elif args.structured:
            mesh = make_cartesian_3d(n, n, n)
            fes = CartesianFESpace(mesh, order, (n, n, n))
        else:
            mesh = make_cartesian_3d(n, n, n)
            fes = FESpace(mesh, order)
        for bp, kind in (("BP1", "mass"), ("BP3", "diffusion")):
            a = BilinearForm(fes).add_domain_integrator(kind)
            ess = fes.essential_dofs() if kind == "diffusion" else []
            if args.ell and order > 1:
                # variable-width rows: bucketed multi-ELL in permuted space
                from cardiac_ablation_ecm2.ops.ell import MultiELLOperator

                op = MultiELLOperator.from_csr(a.assemble_matrix(),
                                               args.dtype).operator()
            elif args.ell:
                op = a.assemble_ell().operator()
            else:
                op = a.assemble().operator()
            A = ConstrainedOperator.wrap(op, ess)
            M = jacobi(A.diagonal())
            b = jnp.ones(fes.ndof, dtype=jnp.dtype(args.dtype))
            iters = args.iters

            @jax.jit
            def solve(b):
                return cg(A.mult, b, M=M, rel_tol=0.0, max_iter=iters,
                          check_convergence=False)

            x, info = solve(b)
            jax.block_until_ready(x)
            t0 = time.perf_counter()
            x, info = solve(b)
            jax.block_until_ready(x)
            dt_s = time.perf_counter() - t0
            mdofs = fes.ndof * iters / dt_s / 1e6
            print(json.dumps({
                "bench": bp, "order": order, "ndof": fes.ndof,
                "cg_iters": iters, "seconds": round(dt_s, 4),
                "MDof_per_s": round(mdofs, 2),
                "dtype": args.dtype,
                "device": device, "card": card,
                "structured": args.structured,
                "simplex": args.simplex,
                "ell": args.ell,
            }), flush=True)


if __name__ == "__main__":
    from cardiac_ablation_ecm2.utils.device import NoGPUError

    try:
        main()
    except NoGPUError as e:
        sys.exit(f"bp.py: {e}")
