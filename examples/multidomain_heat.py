"""Multidomain coupled heat transfer: tissue + catheter subdomains with
interface temperature transfer (reference miniapps/multidomain/
multidomain.cpp — solid/fluid coupling via SubMesh + TransferMap)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Two-domain heat conduction coupled via SubMesh")
    ap.add_argument("-n", "--ncell", type=int, default=6)
    ap.add_argument("-s", "--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.gridfunction import project
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_3d
    from cardiac_ablation_ecm2.mesh.submesh import (
        create_from_domain,
        create_transfer_map,
    )
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    # parent: unit cube; catheter = inner column (attribute 2)
    n = args.ncell
    m = make_cartesian_3d(n, n, n)
    cent = m.vertices[m.elements].mean(axis=1)
    inner = ((np.abs(cent[:, 0] - 0.5) < 0.25)
             & (np.abs(cent[:, 1] - 0.5) < 0.25))
    parent = Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                  attributes=np.where(inner, 2, 1), boundary=m.boundary,
                  bdr_attributes=m.bdr_attributes)

    tissue = create_from_domain(parent, [1])
    cath = create_from_domain(parent, [2])
    p = args.order
    pfes = FESpace(parent, p)
    tfes = FESpace(tissue.mesh, p)
    cfes = FESpace(cath.mesh, p)
    tm_t = create_transfer_map(pfes, tfes, tissue)
    tm_c = create_transfer_map(pfes, cfes, cath)

    def heat_step(fes, u, dt, kappa, ess_dofs, ess_vals, q=None):
        """One backward-Euler step of u_t = ∇·(κ∇u) + q."""
        M = BilinearForm(fes).add_domain_integrator("mass").assemble()
        A = BilinearForm(fes).add_domain_integrator(
            "diffusion", kappa).assemble()
        mvec = jnp.ones(fes.ndof_scalar).at[ess_dofs].set(0.0)
        b = M.mult(u)
        if q is not None:
            b = b + dt * domain_lf(fes, q)

        def lhs(v):
            z = v * mvec
            return (M.mult(z) + dt * A.mult(z)) * mvec + (v - z)

        b = (b - lhs(ess_vals * (1 - mvec))) * mvec + ess_vals * (1 - mvec)
        x, info = cg(lhs, b, rel_tol=1e-10, max_iter=2000)
        return x, info

    # initial: everything at 37; catheter heats volumetrically
    Tp = project(pfes, lambda x: 37.0 + 0 * np.asarray(x)[..., 0])
    new_attr = int(parent.bdr_attributes.max()) + 1   # interface marker
    iface_t = jnp.asarray(tfes.essential_dofs([new_attr]))
    outer_t = jnp.asarray(tfes.essential_dofs([1, 2, 3, 4, 5, 6]))

    for step in range(args.steps):
        # catheter: heated, interface temperature free (natural) —
        # solve with source, then push T onto the parent
        Tc = tm_c.to_sub(Tp)
        Tc, _ = heat_step(cfes, Tc, args.dt, 0.1,
                          jnp.zeros(0, jnp.int32), jnp.zeros_like(Tc),
                          q=lambda x: 80.0 + 0 * np.asarray(x)[..., 0])
        Tp = tm_c.to_parent(Tc, Tp)

        # tissue: Dirichlet 37 on the outer boundary, interface values
        # taken from the parent field (catheter side)
        Tt = tm_t.to_sub(Tp)
        ess = jnp.concatenate([outer_t, iface_t])
        vals = jnp.zeros_like(Tt).at[outer_t].set(37.0).at[iface_t].set(
            Tt[iface_t])
        Tt, info = heat_step(tfes, Tt, args.dt, 0.5, ess, vals)
        Tp = tm_t.to_parent(Tt, Tp)
        print(f"step {step}: catheter max {float(Tc.max()):.3f}  "
              f"tissue max {float(Tt.max()):.3f}  iters {info.iterations}")

    assert float(Tc.max()) > 37.5, "catheter should heat up"
    print("OK: interface-coupled two-domain transient heat")


if __name__ == "__main__":
    main()
