"""Example 28: sliding boundary conditions via the ConstrainedSolver
framework (reference examples/ex28.cpp analog).

A trapezoid is pushed from the right into a rigid notch; the normal
displacement on the bottom (attr 1) and the slanted left side (attr 4) is
constrained to zero while tangential sliding is allowed.

  python examples/ex28_sliding.py --cpu -o 2 --offset 0.3 --solver schur
"""

import numpy as np
from common import maybe_vtu, setup_jax, standard_parser


def main():
    ap = standard_parser("ex28: elasticity with sliding (normal) constraints")
    ap.add_argument("--offset", type=float, default=0.3)
    ap.add_argument("--n", type=int, default=16, help="elements per side")
    ap.add_argument("--solver", default="eliminate",
                    choices=["eliminate", "penalty", "schur"])
    ap.add_argument("--tol", type=float, default=1e-10)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg import constrained
    from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import boundary_lf_vector

    # ex28's build_trapezoid_mesh: unit square with the top-left corner
    # pulled right to (offset, 1)
    m0 = make_cartesian_2d(args.n, args.n)
    V = m0.vertices.copy()
    V[:, 0] = V[:, 0] + (1.0 - V[:, 0]) * args.offset * V[:, 1]
    mesh = Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                attributes=m0.attributes, boundary=m0.boundary,
                bdr_attributes=m0.bdr_attributes)

    fes = FESpace(mesh, args.order, vdim=2)
    A = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()
    b = boundary_lf_vector(fes, np.array([-5.0e-2, 0.0]), bdr_marker=[2])
    B = constrained.build_normal_constraints(fes, [1, 4], dtype=b.dtype)
    print(f"ndof={fes.ndof}  constraints={B.m} "
          f"(blocks={len(B.rowstarts) - 1})")

    diag = A.diagonal()
    if args.solver == "eliminate":
        x, lam, info = constrained.eliminate_constrained_solve(
            A.mult, B, b, M=lambda v: v / diag, rel_tol=args.tol,
            max_iter=8000)
    elif args.solver == "penalty":
        x, lam, info = constrained.penalty_constrained_solve(
            A.mult, B, b, penalty=1e10, M=lambda v: v / diag,
            rel_tol=args.tol, max_iter=8000)
    else:
        x, lam, info = constrained.schur_constrained_solve(
            A.mult, B, b, Adiag=diag, rel_tol=args.tol, max_iter=16000)

    viol = float(jnp.abs(B.mult(x)).max())
    print(f"{args.solver}: iters={int(info.iterations)} "
          f"converged={bool(info.converged)}  |Bx|_inf={viol:.3e}  "
          f"|u|_inf={float(jnp.abs(x).max()):.6f}  "
          f"|lambda|_inf={float(jnp.abs(lam).max()):.4e}")
    maybe_vtu(args, mesh, fes, x[:fes.ndof_scalar], name="ux")


if __name__ == "__main__":
    main()
