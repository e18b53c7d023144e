"""Example 13: Maxwell cavity eigenmodes (reference examples/ex13p.cpp —
HypreAME on an ND space; here LOBPCG + algebraic gradient projection)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Maxwell cavity eigenvalues on [0,1]^d")
    ap.add_argument("-k", "--num", type=int, default=3)
    ap.add_argument("-n", "--ncell", type=int, default=4)
    ap.add_argument("-d", "--dim", type=int, default=2, choices=[2, 3])
    args = ap.parse_args()
    setup_jax(args)
    # modal analysis is a setup-time computation, not a hot path: the
    # nested projection solves (1e-10) need f64 accumulation
    import jax

    jax.config.update("jax_enable_x64", True)

    from cardiac_ablation_ecm2.fem.fespace import FESpace
    from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
    from cardiac_ablation_ecm2.linalg.maxwell_eigen import (
        maxwell_eigenvalues,
    )
    from cardiac_ablation_ecm2.mesh.mesh import (
        make_cartesian_2d,
        make_cartesian_3d,
    )

    n = args.ncell
    mesh = (make_cartesian_2d(n, n) if args.dim == 2
            else make_cartesian_3d(n, n, n))
    order = max(args.order, 1)
    nd = NDSpaceHO(mesh, order)
    h1 = FESpace(mesh, order)
    res = maxwell_eigenvalues(nd, h1, k=args.num, iters=60)
    lam = np.sort(res.eigenvalues)
    print("eigenvalues:", " ".join(f"{v:.6f}" for v in lam))
    print("eigenvalues/pi^2:", " ".join(f"{v / np.pi ** 2:.4f}"
                                        for v in lam))


if __name__ == "__main__":
    main()
