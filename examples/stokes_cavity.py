"""Steady Stokes: lid-driven cavity on a Taylor–Hood P2–P1 pair.

Reference analog: the steady-Stokes block systems of miniapps/fluids
(and ex5's saddle-point structure), built from the VectorDivergence /
Gradient integrator analogs (ops/mixed_vecfe.py).  MINRES on the
symmetric saddle system with Dirichlet masking and a rank-one pressure
mean gauge.

  python examples/stokes_cavity.py --cpu -n 12
"""

import numpy as np
from common import maybe_vtu, setup_jax, standard_parser


def main():
    ap = standard_parser("Stokes lid-driven cavity (Taylor-Hood P2-P1)")
    ap.add_argument("-n", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-10)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.krylov_extra import minres
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.mixed_vecfe import vector_divergence

    mesh = make_cartesian_2d(args.n, args.n)
    V = FESpace(mesh, max(args.order, 2), vdim=2)
    Q = FESpace(mesh, max(args.order, 2) - 1)
    nu, ns = V.ndof, V.ndof_scalar
    print(f"velocity dofs {nu}, pressure dofs {Q.ndof_scalar}")

    A = BilinearForm(V).add_domain_integrator("diffusion").assemble()
    D = vector_divergence(V, Q)

    ess = V.essential_dofs([1, 2, 3, 4])
    lid = V.essential_dofs([3])
    fm = jnp.zeros(nu).at[
        jnp.asarray(np.concatenate([ess, ess + ns]))].set(1.0)
    fv = jnp.zeros(nu).at[jnp.asarray(lid)].set(1.0) * fm
    free = 1.0 - fm

    wq = np.asarray(BilinearForm(Q).add_domain_integrator(
        "mass").assemble_matrix().sum(axis=1)).ravel()
    wq = jnp.asarray(wq / wq.sum())

    def K(z):
        u, p = z[:nu], z[nu:]
        uf = u * free
        up = (A.mult(uf) * free + (u - uf)) - D.mult_t(p) * free
        return jnp.concatenate([up, -D.mult(uf) + wq * jnp.sum(p * wq)])

    rhs = jnp.concatenate([(-A.mult(fv)) * free + fv, D.mult(fv)])
    dA = A.diagonal() * free + fm
    z, info = minres(
        K, rhs, M=lambda z: jnp.concatenate([z[:nu] / dA, z[nu:]]),
        rel_tol=args.tol, max_iter=40000)
    u = z[:nu] * free + fv
    p = z[nu:] - jnp.sum(z[nu:] * wq)
    div = float(jnp.abs(D.mult(u)).max())
    print(f"MINRES iters={int(info.iterations)} converged="
          f"{bool(info.converged)}  max|weak div u|={div:.3e}  "
          f"u_center=({float(u[ns // 2]):.4f})")
    maybe_vtu(args, mesh, V, u[:ns], name="ux")


if __name__ == "__main__":
    main()
