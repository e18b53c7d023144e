"""Two-body frictionless contact via mortar constraints + PDAS.

Reference analog: ``miniapps/contact`` (mortar pairing + active-set).
An upper elastic block is driven down onto a lower block across an
initial gap; the weak non-penetration constraints close on the active
set and transmit nonnegative contact pressure.

  python examples/mortar_contact.py --cpu --x64 --delta 0.05 --gap 0.02
  python examples/mortar_contact.py --cpu --x64 --nonmatching
"""

import numpy as np
from common import setup_jax, standard_parser


def main():
    ap = standard_parser("two-body mortar contact (PDAS)")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--gap", type=float, default=0.02)
    ap.add_argument("--delta", type=float, default=0.05,
                    help="downward drive of the upper block's top face")
    ap.add_argument("--nonmatching", action="store_true",
                    help="upper block meshed finer than the lower")
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.mortar import (
        build_mortar_constraints, contact_solve)
    from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
    from cardiac_ablation_ecm2.ops import BilinearForm

    n_lo, n_hi = args.n, (args.n + 2 if args.nonmatching else args.n)
    lo = make_cartesian_2d(n_lo, args.n)
    hi = make_cartesian_2d(n_hi, args.n)
    Vhi = hi.vertices.copy()
    Vhi[:, 1] += 1.0 + args.gap
    att_lo = lo.bdr_attributes.copy()
    att_lo[att_lo == 3] = 8                     # lower top = master
    att_hi = hi.bdr_attributes.copy()
    att_hi[att_hi == 1] = 7                     # upper bottom = slave
    att_hi[att_hi == 2] = 12
    att_hi[att_hi == 4] = 14
    mesh = Mesh(
        geom=lo.geom,
        vertices=np.concatenate([lo.vertices, Vhi]),
        elements=np.concatenate([lo.elements,
                                 hi.elements + lo.vertices.shape[0]]),
        attributes=np.concatenate([lo.attributes, hi.attributes + 1]),
        boundary=np.concatenate([lo.boundary,
                                 hi.boundary + lo.vertices.shape[0]]),
        bdr_attributes=np.concatenate([att_lo, att_hi]))

    fes = FESpace(mesh, args.order if args.order > 0 else 1, vdim=2)
    ns = fes.ndof_scalar
    A = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()

    ess_lo = fes.essential_dofs([1])
    ess_hi = fes.essential_dofs([3])
    fixed = np.concatenate([ess_lo, ess_lo + ns, ess_hi, ess_hi + ns])
    fm = jnp.zeros(fes.ndof).at[jnp.asarray(fixed)].set(1.0)
    fv = jnp.zeros(fes.ndof).at[jnp.asarray(ess_hi + ns)].set(-args.delta)

    pair = build_mortar_constraints(fes, [7], [8], normal_only=True,
                                    max_pair_dist=0.5)
    print(f"ndof={fes.ndof}  mortar multipliers={pair.B.m}  "
          f"mean initial gap={pair.gaps.mean():.4f}")

    u, lam, outer = contact_solve(
        A.mult, pair, jnp.zeros(fes.ndof), diag=A.diagonal(),
        fixed_mask=fm, fixed_vals=fv * fm, rel_tol=1e-11)

    g = pair.gaps + np.asarray(pair.B.mult(u))
    lam = np.asarray(lam)
    print(f"PDAS outer iterations: {outer}")
    print(f"weak gaps: min={g.min():.3e}  open={int((g > 1e-8).sum())}"
          f"/{len(g)}")
    print(f"contact pressure: min={lam.min():.3e}  max={lam.max():.3e}  "
          f"active={int((lam > 1e-10).sum())}")
    assert g.min() > -1e-9 and lam.min() > -1e-9


if __name__ == "__main__":
    main()
