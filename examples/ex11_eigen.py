"""Example 11: Laplace eigenmodes via LOBPCG (reference examples/ex11p.cpp)."""

import numpy as np

from common import load_mesh, setup_jax, standard_parser


def main():
    ap = standard_parser("Smallest Dirichlet Laplace eigenvalues (LOBPCG)")
    ap.add_argument("-k", "--num", type=int, default=5)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.lobpcg import lobpcg
    from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator

    mesh = load_mesh(args, "inline-quad-12")
    fes = FESpace(mesh, args.order)
    ess = jnp.asarray(fes.essential_dofs())
    A = ConstrainedOperator.wrap(
        BilinearForm(fes).add_domain_integrator("diffusion").assemble().operator(),
        np.asarray(ess),
    )
    M_pa = BilinearForm(fes).add_domain_integrator("mass").assemble()

    proj = lambda v: v.at[ess].set(0.0)
    Mop = lambda v: proj(M_pa.mult(proj(v)))
    diag = A.diagonal()
    res = lobpcg(A.mult, Mop, fes.ndof, k=args.num,
                 precond=lambda r: r / diag, iters=60, constraint=proj)
    lam = np.sort(np.asarray(res.eigenvalues))
    print("eigenvalues:", " ".join(f"{v:.6f}" for v in lam))
    print("eigenvalues/pi^2:", " ".join(f"{v/np.pi**2:.4f}" for v in lam))


if __name__ == "__main__":
    main()
