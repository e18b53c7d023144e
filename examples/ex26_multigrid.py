"""Example 26: p-multigrid preconditioned Poisson (reference examples/ex26.cpp)."""

import numpy as np

from common import load_mesh, setup_jax, standard_parser


def main():
    ap = standard_parser("Poisson with p-multigrid-PCG vs Jacobi-PCG")
    args = ap.parse_args()
    if args.order < 2:
        args.order = 4
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.multigrid import make_p_multigrid
    from cardiac_ablation_ecm2.linalg.smoothers import jacobi
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    mesh = load_mesh(args, "inline-quad-16")
    orders = [1]
    while orders[-1] * 2 <= args.order:
        orders.append(orders[-1] * 2)
    if orders[-1] != args.order:
        orders.append(args.order)

    spaces = {p: FESpace(mesh, p) for p in orders}

    def opf(fes):
        return ConstrainedOperator.wrap(
            BilinearForm(fes).add_domain_integrator("diffusion")
            .assemble().operator(),
            fes.essential_dofs(),
        )

    mg = make_p_multigrid(
        lambda p: spaces[p], opf, orders,
        ess_factory=lambda f: f.essential_dofs(),
    )
    fes = spaces[args.order]
    A = opf(fes)
    b = domain_lf(fes, None)
    b = b.at[jnp.asarray(fes.essential_dofs())].set(0.0)

    x1, i1 = cg(A.mult, b, M=jacobi(A.diagonal()), rel_tol=1e-10, max_iter=2000)
    x2, i2 = cg(A.mult, b, M=mg.preconditioner(), rel_tol=1e-10, max_iter=200)
    print(f"ndof={fes.ndof}  order={args.order}  levels={orders}")
    print(f"Jacobi-PCG iters: {int(i1.iterations)}   "
          f"MG-PCG iters: {int(i2.iterations)}")
    print(f"solutions agree: {np.allclose(np.asarray(x1), np.asarray(x2), atol=1e-7)}")


if __name__ == "__main__":
    main()
