"""Example 1: Poisson with PCG+Jacobi (reference examples/ex1.cpp analog).

  python examples/ex1_poisson.py -m /root/reference/data/star.mesh -o 2
"""

from common import load_mesh, maybe_vtu, setup_jax, standard_parser


def main():
    ap = standard_parser("Poisson: -div(grad u) = 1, u=0 on boundary")
    ap.add_argument("--prec", default="jacobi",
                    choices=["jacobi", "chebyshev", "lor", "none"])
    ap.add_argument("--tol", type=float, default=1e-10)
    args = ap.parse_args()
    setup_jax(args)

    from cardiac_ablation_ecm2.models import poisson

    mesh = load_mesh(args, "inline-quad-16")
    res = poisson.solve(
        mesh, order=args.order, rhs=1.0, rel_tol=args.tol,
        preconditioner=None if args.prec == "none" else args.prec,
    )
    print(f"ndof={res.fes.ndof}  CG iters={res.iterations}  "
          f"converged={res.converged}  |r|={res.final_norm:.3e}")
    maybe_vtu(args, mesh, res.fes, res.u)


if __name__ == "__main__":
    main()
