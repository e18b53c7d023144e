"""Example 5: mixed Darcy saddle point on RT0×P0 (reference examples/ex5.cpp)."""

import numpy as np

from common import load_mesh, setup_jax, standard_parser


def main():
    ap = standard_parser("Darcy: M u + B^T p = 0, B u = g, MINRES block-prec")
    args = ap.parse_args()
    setup_jax(args)

    from cardiac_ablation_ecm2.models import darcy

    mesh = load_mesh(args, "inline-quad-8")

    def g(x):
        x = np.asarray(x)
        return (
            2 * np.pi**2 * np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
        )

    res = darcy.solve(mesh, g_fn=g, rel_tol=1e-10)
    print(f"RT dofs={res.rt.ndof}  L2 dofs={res.l2.ndof_scalar}  "
          f"MINRES iters={res.iterations}  converged={res.converged}")


if __name__ == "__main__":
    main()
