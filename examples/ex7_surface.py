"""Example 7: Laplace on an embedded sphere surface
(reference examples/ex7.cpp — here the Laplace–Beltrami spectrum)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Laplace-Beltrami eigenmodes on the unit sphere")
    ap.add_argument("-n", "--ncell", type=int, default=6)
    ap.add_argument("-k", "--num", type=int, default=5)
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.lobpcg import lobpcg
    from cardiac_ablation_ecm2.mesh.surface import make_sphere_quad
    from cardiac_ablation_ecm2.ops.surface import surface_operators

    order = max(args.order, 1)
    mesh = make_sphere_quad(args.ncell, curved_order=max(order, 2))
    fes = FESpace(mesh, order)
    Amult, Adiag = surface_operators(fes, diffusion_coeff=1.0)
    Mmult, _ = surface_operators(fes, mass_coeff=1.0)
    d = jnp.maximum(Adiag(), 1e-12)
    res = lobpcg(Amult, Mmult, fes.ndof_scalar, k=args.num,
                 precond=lambda r: r / d, iters=80)
    lam = np.sort(np.asarray(res.eigenvalues))
    print(f"dofs: {fes.ndof_scalar}  (cubed-sphere {args.ncell}², "
          f"order {order}, curved geometry)")
    print("eigenvalues:", " ".join(f"{v:.5f}" for v in lam))
    print("exact:       l(l+1) = 0, 2 (×3), 6 (×5), …")


if __name__ == "__main__":
    main()
