"""SPDE miniapp analog: sample Matérn/Whittle Gaussian random fields by
solving A^α u = η W with white-noise RHS (reference
miniapps/spde/generate_random_field.cpp; formulas in its README.md).

Prints Monte-Carlo marginal statistics at the domain center — the η
normalization makes the theoretical pointwise std 1 (away from the
Dirichlet boundary-dip)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Matérn random fields via the fractional SPDE")
    ap.add_argument("-nu", type=float, default=1.0, help="smoothness ν")
    ap.add_argument("-l", "--ell", type=float, default=0.2,
                    help="correlation length ℓ")
    ap.add_argument("-n", "--ncell", type=int, default=24)
    ap.add_argument("-ns", "--samples", type=int, default=200)
    ap.add_argument("--save", default=None, help="write first sample as VTU")
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2.models.spde import sample_matern_field

    mesh = make_cartesian_2d(args.ncell, args.ncell)
    fes = FESpace(mesh, max(args.order, 1))
    U = np.asarray(sample_matern_field(fes, 0, nu=args.nu, ell=args.ell,
                                       num=args.samples))
    X = np.asarray(fes.dof_coords)
    ctr = int(np.argmin(((X - 0.5) ** 2).sum(axis=1)))
    std_c = U[:, ctr].std()
    print(f"Matérn(ν={args.nu}, ℓ={args.ell}) on {args.ncell}² mesh, "
          f"{args.samples} samples: center mean={U[:, ctr].mean():+.3f} "
          f"std={std_c:.3f} (theory 1.0 ± MC/boundary effects)")
    if args.save:
        from cardiac_ablation_ecm2.io import save_vtu

        save_vtu(args.save, fes, {"u": U[0]})
        print(f"wrote {args.save}")


if __name__ == "__main__":
    main()
