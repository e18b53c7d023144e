"""Flagship app: RF cardiac ablation — electrostatic potential → SAR →
Pennes bioheat → Arrhenius lesion (BASELINE configs 3-4).

  python examples/ablation_demo.py --n 8 --t-final 30 --dt 0.5
"""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Coupled RF ablation on a tissue block")
    ap.add_argument("--n", type=int, default=6, help="elements per axis")
    ap.add_argument("--size", type=float, default=0.02, help="block size [m]")
    ap.add_argument("--voltage", type=float, default=50.0)
    ap.add_argument("--dt", type=float, default=0.5)
    ap.add_argument("--t-final", type=float, default=10.0)
    ap.add_argument("--resolve-every", type=int, default=0, metavar="N",
                    help="re-solve the potential with sigma(T) every N steps"
                         " (temperature feedback; 0 = one-shot)")
    ap.add_argument("--sigma-alpha", type=float, default=0.015,
                    help="d(sigma)/dT fractional rise per degC")
    ap.add_argument("--k-alpha", type=float, default=0.0,
                    help="d(k)/dT fractional rise per degC (0 = constant k)")
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.models import ablation

    L = args.size
    sigma0, k0 = 0.54, 0.54
    coupled = {}
    if args.resolve_every:
        coupled["resolve_every"] = args.resolve_every
        coupled["sigma_T"] = (
            lambda Tq: sigma0 * (1.0 + args.sigma_alpha * (Tq - 37.0)))
    if args.k_alpha:
        coupled["k_T"] = (
            lambda Tq: k0 * (1.0 + args.k_alpha * (Tq - 37.0)))

    mesh = make_cartesian_3d(args.n, args.n, args.n, L, L, L)
    sim = ablation.AblationSim(
        mesh=mesh, order=args.order, voltage=args.voltage, sigma=sigma0,
        electrode_bdr=[6], ground_bdr=[1], **coupled,
    )
    print(f"RF solve: {sim.rf.iterations} CG iters, "
          f"P = {float(jnp.sum(sim.op.gf.wdet * sim.rf.sar_q)):.3f} W")
    T, om = sim.initial_state()
    t = 0.0
    n = int(round(args.t_final / args.dt))
    chunk = max(n // 10, 1)
    for k in range(0, n, chunk):
        steps = min(chunk, n - k)
        T, om, t = sim.run(t + steps * args.dt, args.dt, T, om, t0=t)
        extra = ""
        if args.resolve_every:
            extra = (f"  P={float(jnp.sum(sim.op.gf.wdet * sim.sar_q)):.3f} W")
        print(f"t={float(t):6.1f}s  Tmax={float(jnp.max(T)):.2f}C  "
              f"lesion={sim.lesion_volume(om)*1e9:.1f} mm^3{extra}")


if __name__ == "__main__":
    main()
