"""Example 4: H(div) — (div σ, div τ) + (σ, τ) = (f, τ) on Raviart-Thomas
(reference examples/ex4.cpp).  Essential normal BC σ·n = 0; exact
σ = (sin πx cos πy cos πz, cos·sin·cos, cos·cos·sin) ⇒ f = (1+3π²)σ."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("H(div) div-div + mass on RT_k (ex4 analog)")
    ap.add_argument("-n", type=int, default=4)
    ap.add_argument("--varcoeff", action="store_true",
                    help="spatially varying c(x)=1+x in the div-div term")
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.fe_vector_ho import RTSpaceHO
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.vecfe import (
        build_rt_operator,
        vecfe_linear_form,
    )

    order = max(args.order, 1)
    mesh = make_cartesian_3d(args.n, args.n, args.n)
    space = RTSpaceHO(mesh, order)
    print(f"RT_{order} on {mesh.ne} hexes: {space.ndof} dofs")
    dd = (lambda x: 1.0 + x[..., 0]) if args.varcoeff else 1.0
    op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=dd,
                           nq1d=order + 2)

    def sig(x):
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        return np.stack([s[..., 0] * c[..., 1] * c[..., 2],
                         c[..., 0] * s[..., 1] * c[..., 2],
                         c[..., 0] * c[..., 1] * s[..., 2]], axis=-1)

    def f(x):
        if not args.varcoeff:
            return (1 + 3 * np.pi**2) * sig(x)
        # f = σ − ∇(c ∇·σ) with c = 1 + x, ∇·σ = 3π cosπx cosπy cosπz
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        C = c[..., 0] * c[..., 1] * c[..., 2]
        cx = 1.0 + x[..., 0]
        grad = 3 * np.pi * np.stack([
            C - np.pi * cx * s[..., 0] * c[..., 1] * c[..., 2],
            -np.pi * cx * c[..., 0] * s[..., 1] * c[..., 2],
            -np.pi * cx * c[..., 0] * c[..., 1] * s[..., 2]], axis=-1)
        return sig(x) - grad

    b = vecfe_linear_form(op, f)
    ess = space.essential_dofs(None)
    mask = np.zeros(space.ndof)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = op.diagonal()
    x, info = cg(Aop, b * (1 - mask),
                 M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                 rel_tol=1e-10, max_iter=4000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    ex = sig(np.asarray(op.gf.x))
    w = np.asarray(op.gf.wdet)
    err = np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2))
    print(f"CG iters {int(info.iterations)}; ||σ_h − σ||_L2 = {err:.4e}")


if __name__ == "__main__":
    main()
