"""Example 33: spectral fractional Laplacian (−Δ)^s u = f
(reference examples/ex33.cpp — rational approximation; here sinc
quadrature over shifted solves)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Fractional Poisson on the unit square")
    ap.add_argument("-s", "--power", type=float, default=0.5)
    ap.add_argument("-n", "--ncell", type=int, default=10)
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.gridfunction import l2_error
    from cardiac_ablation_ecm2.linalg.fractional import fractional_solve
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    s = args.power
    mesh = make_cartesian_2d(args.ncell, args.ncell)
    fes = FESpace(mesh, max(args.order, 1))
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    M = BilinearForm(fes).add_domain_integrator("mass").assemble()
    ess = jnp.asarray(fes.essential_dofs())
    m = jnp.ones(fes.ndof_scalar).at[ess].set(0.0)
    Am = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mm = lambda v: M.mult(v * m) * m + v * (1 - m)
    dA = A.diagonal() * m + (1 - m)
    dM = M.diagonal() * m + (1 - m)

    f = lambda x: np.sin(np.pi * np.asarray(x)[..., 0]) * np.sin(
        np.pi * np.asarray(x)[..., 1])
    b = domain_lf(fes, f) * m
    u = fractional_solve(Am, Mm, dA, dM, s, b,
                         lam_min=2 * np.pi ** 2 / 4, lam_max=1e5)
    exact = lambda x: (2 * np.pi ** 2) ** (-s) * f(x)
    err = float(l2_error(fes, u, exact))
    print(f"(−Δ)^{s} u = sin πx sin πy: ndof={fes.ndof_scalar}  "
          f"L2 err vs closed form = {err:.3e}  "
          f"(scale (2π²)^-s = {(2 * np.pi ** 2) ** (-s):.4f})")


if __name__ == "__main__":
    main()
