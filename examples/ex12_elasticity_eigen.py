"""Example 12: linear elasticity eigenmodes of a clamped beam
(reference examples/ex12p.cpp — LOBPCG on the elasticity pencil)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Lowest elasticity eigenmodes, clamped-left beam")
    ap.add_argument("-k", "--num", type=int, default=4)
    ap.add_argument("-n", "--ncell", type=int, default=8)
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)   # modal analysis: f64
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg.lobpcg import lobpcg
    from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm

    # beam 8×1 aspect, clamped on the left (attribute 4)
    n = args.ncell
    m = make_cartesian_2d(8 * n, n)
    V = m.vertices.copy()
    V[:, 0] *= 8.0
    mesh = Mesh(geom=m.geom, vertices=V, elements=m.elements,
                attributes=m.attributes, boundary=m.boundary,
                bdr_attributes=m.bdr_attributes)
    fes = FESpace(mesh, args.order, vdim=2)
    A_pa = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()
    M_pa = BilinearForm(fes).add_domain_integrator("mass").assemble()

    ess_scalar = fes.essential_dofs([4])    # clamp x=0 (all components)
    ess = jnp.asarray(np.concatenate(
        [ess_scalar + c * fes.ndof_scalar for c in range(2)]))

    def proj(v):
        return v.at[ess].set(0.0)

    Aop = lambda v: proj(A_pa.mult(proj(v)))
    Mop = lambda v: proj(M_pa.mult(proj(v)))
    diag = jnp.maximum(A_pa.diagonal(), 1e-12)
    res = lobpcg(Aop, Mop, fes.ndof, k=args.num,
                 precond=lambda r: r / diag, iters=80, constraint=proj)
    lam = np.sort(np.asarray(res.eigenvalues))
    print("eigenvalues:", " ".join(f"{v:.6f}" for v in lam))
    print("frequencies:", " ".join(f"{np.sqrt(max(v, 0)):.4f}"
                                   for v in lam))


if __name__ == "__main__":
    main()
