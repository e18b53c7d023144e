"""Boundary-layer anisotropic AMR: resolve u = e^{-z/eps} on [0,1]^3 by
Z-only NC hex refinement (reference ref_type X/Y/Z bitmask splits,
mesh/ncmesh.hpp:662 and the aniso statement at :176).

Each round marks elements by the interpolation-error indicator
h_z^3 * e^{-z_min/eps} and splits them in z only, producing a graded
boundary-layer mesh at a fraction of the dofs isotropic refinement would
need; the nonconforming Poisson solve then converges to the manufactured
layer solution.
"""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Anisotropic boundary-layer AMR (NC hex Z-splits)")
    ap.add_argument("-n", "--ncell", type=int, default=4)
    ap.add_argument("-e", "--eps", type=float, default=0.15)
    ap.add_argument("-s", "--rounds", type=int, default=3)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.build import (basis_for,
                                                     geom_factors_for,
                                                     restriction_for)
    from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2.fem.quadinterp import eval_values
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.mesh.ncmesh import (Z3, make_nc,
                                                       refine_hexes_aniso)
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    eps = args.eps

    def u_ex(x):
        x = np.asarray(x)
        return np.exp(-x[..., 2] / eps)

    def rhs(x):
        return -u_ex(x) / eps**2

    nc = make_nc(make_cartesian_3d(args.ncell, args.ncell, args.ncell))
    for rounds in range(args.rounds + 1):
        nc_r = nc
        for _ in range(rounds):
            v = nc_r.mesh.vertices[nc_r.mesh.elements][..., 2]
            zmin = v.min(axis=1)
            hz = v.max(axis=1) - zmin
            ind = hz**3 * np.exp(-zmin / eps)
            types = np.where(ind > 0.2 * ind.max(), Z3, 0)
            nc_r, _ = refine_hexes_aniso(nc_r, types)

        spc = NCFESpace(nc_r, args.order)
        A_L = BilinearForm(spc.fes).add_domain_integrator(
            "diffusion").assemble()
        Ac = spc.constrained_operator(A_L.mult)
        b = spc.restrict_t(domain_lf(spc.fes, rhs))
        ess = spc.essential_dofs(None)
        mask = np.zeros(spc.ndof_conf)
        mask[ess] = 1.0
        mask = jnp.asarray(mask)
        xb = jnp.asarray(u_ex(spc.dof_coords)) * mask

        def Abc(v):
            z = v * (1 - mask)
            return Ac(z) * (1 - mask) + v * mask

        B = (b - Ac(xb)) * (1 - mask) + xb
        x, info = cg(Abc, B, M=lambda r: r, rel_tol=1e-10, max_iter=3000)
        uL = spc.prolongate(x)
        fes = spc.fes
        uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
        gf = geom_factors_for(fes)
        err = float(np.sqrt(np.sum(
            np.asarray(gf.wdet)
            * (np.asarray(uq) - u_ex(np.asarray(gf.x))) ** 2)))
        print(f"rounds={rounds}: elements={nc_r.mesh.ne} "
              f"conforming dofs={spc.ndof_conf} "
              f"hanging={nc_r.n_hanging} cg_iters={int(info.iterations)} "
              f"L2 layer error={err:.3e}")


if __name__ == "__main__":
    main()
