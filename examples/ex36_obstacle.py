"""Example 36: membrane obstacle problem (reference examples/ex36.cpp —
proximal Galerkin; here primal–dual active set)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Membrane pressed onto a flat obstacle")
    ap.add_argument("-n", "--ncell", type=int, default=24)
    ap.add_argument("--gap", type=float, default=0.08)
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.obstacle import obstacle_solve
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    mesh = make_cartesian_2d(args.ncell, args.ncell)
    fes = FESpace(mesh, max(args.order, 1))
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    b = domain_lf(fes, lambda x: -8.0 + 0 * np.asarray(x)[..., 0])
    ess = fes.essential_dofs()
    fm = jnp.zeros(fes.ndof_scalar).at[jnp.asarray(ess)].set(1.0)
    psi = jnp.full(fes.ndof_scalar, -args.gap)

    u, lam, outer = obstacle_solve(A.mult, b, psi, diag=A.diagonal(),
                                   fixed_mask=fm)
    contact = np.asarray(lam) > 1e-10
    print(f"PDAS converged in {outer} outer iterations; "
          f"contact dofs {int(contact.sum())}/{fes.ndof_scalar}; "
          f"u_min = {float(u.min()):.5f} (obstacle at {-args.gap})")
    assert float(u.min()) >= -args.gap - 1e-10


if __name__ == "__main__":
    main()
