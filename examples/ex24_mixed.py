"""Example 24: mixed FE spaces and discrete interpolators — project the
gradient of an H1 field into H(curl) (reference examples/ex24.cpp)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Gradient projection H1 -> ND via mixed integrators")
    ap.add_argument("-n", "--ncell", type=int, default=3)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.fespace import FESpace
    from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
    from cardiac_ablation_ecm2.fem.gridfunction import project
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.mixed_vecfe import (
        mixed_vector_gradient,
    )
    from cardiac_ablation_ecm2.ops.vecfe import build_nd_operator

    n = args.ncell
    order = max(args.order, 1)
    mesh = make_cartesian_3d(n, n, n)
    h1 = FESpace(mesh, order)
    nd = NDSpaceHO(mesh, order)

    # p(x) = x^2 - y*z: grad p = (2x, -z, -y), |grad p|^2 integral = 4/3+2/3
    u = project(h1, lambda x: x[..., 0] ** 2
                - x[..., 1] * x[..., 2])
    G = mixed_vector_gradient(h1, nd, nq1d=order + 2)
    M = build_nd_operator(nd, mass_coeff=1.0, nq1d=order + 2)
    b = G.mult(jnp.asarray(u))
    g, info = cg(M.mult, b, M=lambda r: r / M.diagonal(),
                 rel_tol=1e-12, max_iter=4000)
    energy = float(g @ M.mult(g))
    exact = 4.0 / 3.0 + 2.0 / 3.0
    print(f"ndof H1={h1.ndof_scalar} ND={nd.ndof}  CG iters={info.iterations}")
    print(f"|grad p|_L2^2 = {energy:.10f}  (exact {exact:.10f}, "
          f"err {abs(energy - exact):.2e})")


if __name__ == "__main__":
    main()
