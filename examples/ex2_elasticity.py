"""Example 2: linear-elastic cantilever (reference examples/ex2.cpp analog).

  python examples/ex2_elasticity.py -m /root/reference/data/beam-quad.mesh
"""

from common import load_mesh, setup_jax, standard_parser


def main():
    ap = standard_parser("Elastic cantilever: fixed attr-1, load on attr-2")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=1.0)
    args = ap.parse_args()
    setup_jax(args)

    from cardiac_ablation_ecm2.models import elasticity

    mesh = load_mesh(args, "/root/reference/data/beam-quad.mesh")
    res = elasticity.solve(mesh, order=args.order, lam=args.lam, mu=args.mu)
    d = res.displacement()
    print(f"ndof={res.fes.ndof}  CG iters={res.iterations}  "
          f"max |u_y| = {abs(d[:, 1]).max():.4e}")


if __name__ == "__main__":
    main()
