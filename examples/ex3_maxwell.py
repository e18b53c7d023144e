"""Example 3: definite Maxwell — curl curl E + E = f on H(curl)
(reference examples/ex3.cpp).  Arbitrary-order Nédélec space, essential
tangential BC E×n = 0, diagonal-preconditioned CG, L2 error vs the exact
divergence-free field E_i = sin(πx_j) sin(πx_k)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Definite Maxwell on ND_k (ex3 analog)")
    ap.add_argument("-n", type=int, default=4)
    ap.add_argument("--ams", action="store_true",
                    help="AMS auxiliary-space preconditioner (order 1; "
                         "n must be a power of 2 for the h-MG hierarchy)")
    args = ap.parse_args()
    setup_jax(args)

    if args.ams:
        run_ams(args)
        return

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.vecfe import (
        build_nd_operator,
        vecfe_linear_form,
    )

    order = max(args.order, 1)
    mesh = make_cartesian_3d(args.n, args.n, args.n)
    space = NDSpaceHO(mesh, order)
    print(f"ND_{order} on {mesh.ne} hexes: {space.ndof} dofs")
    op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                           nq1d=order + 2)

    def E(x):
        s = np.sin(np.pi * x)
        return np.stack([s[..., 1] * s[..., 2],
                         s[..., 2] * s[..., 0],
                         s[..., 0] * s[..., 1]], axis=-1)

    b = vecfe_linear_form(op, lambda x: (2 * np.pi**2 + 1) * E(x))
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
    ex = E(np.asarray(op.gf.x))
    w = np.asarray(op.gf.wdet)
    err = np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2))
    print(f"CG iters {int(info.iterations)}; ||E_h − E||_L2 = {err:.4e}")


def run_ams(args):
    """Order-1 solve with the AMS preconditioner (linalg/ams.py, HypreAMS
    analog) vs Jacobi — prints the iteration comparison.  Forces x64 (the
    1e-10 tolerance is below what plain-f32 inner products can evaluate)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2.linalg.ams import make_ams
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.vecfe import (
        build_nd_operator,
        vecfe_linear_form,
    )

    n = args.n
    meshes = [make_cartesian_3d(2, 2, 2)]
    while meshes[-1].ne * 8 <= n ** 3:
        meshes.append(meshes[-1].uniform_refinement())
    mesh = meshes[-1]
    nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
    print(f"ND_1 on {mesh.ne} hexes: {nd.ndof} dofs "
          f"({len(meshes)}-level h-MG auxiliaries)")
    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0)

    def E(x):
        import numpy as np

        s = np.sin(np.pi * x)
        return np.stack([s[..., 1] * s[..., 2], s[..., 2] * s[..., 0],
                         s[..., 0] * s[..., 1]], axis=-1)

    import numpy as np

    # NOTE: the pure sine-product RHS is an exact discrete eigenmode on a
    # uniform lattice (Jacobi-CG then "converges" in 1 iteration); mix in a
    # generic component so the iteration comparison is meaningful
    b = vecfe_linear_form(
        op, lambda x: (2 * np.pi ** 2 + 1) * E(x)
        + 0.1 * np.stack([1 + x[..., 0] * x[..., 1],
                          x[..., 1] ** 2 - x[..., 2],
                          np.exp(x[..., 0])], axis=-1))
    ess = nd.essential_dofs(None)
    mask = np.ones(nd.ndof)
    mask[ess] = 0.0
    m = jnp.asarray(mask)
    A = lambda v: op.mult(v * m) * m + v * (1 - m)          # noqa: E731
    dg = op.diagonal() * m + (1 - m)
    bm = b * m
    _, ij = cg(A, bm, M=lambda r: r / dg, rel_tol=1e-10, max_iter=8000)
    bdr = sorted(set(mesh.bdr_attributes.tolist()))
    ams = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=meshes)
    x, ia = cg(A, bm, M=ams, rel_tol=1e-10, max_iter=8000)
    print(f"CG iterations: Jacobi {int(ij.iterations)}  "
          f"AMS {int(ia.iterations)}")


if __name__ == "__main__":
    main()
