"""Example 15: dynamic AMR — refine AND derefine tracking a moving front
(reference examples/ex15.cpp)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Dynamic refine/derefine AMR on a moving front")
    ap.add_argument("-n", "--ncell", type=int, default=8)
    ap.add_argument("-s", "--steps", type=int, default=5)
    args = ap.parse_args()
    setup_jax(args)

    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2.mesh.forest import AMRForest
    from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_2d

    forest = AMRForest(make_cartesian_2d(args.ncell, args.ncell))
    for step in range(args.steps):
        t = step / max(args.steps - 1, 1)
        cx, cy = 0.2 + 0.6 * t, 0.5           # moving front center

        h_min = 1.0 / args.ncell / 8                  # ≤3 extra levels
        for _round in range(3):
            m = forest.mesh()
            cent = m.vertices[m.elements].mean(axis=1)
            h = (m.vertices[m.elements].max(axis=1)
                 - m.vertices[m.elements].min(axis=1)).max(axis=1)
            d = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy)
            marks = (d < 0.15) & (h > h_min)
            refined = bool(marks.any())
            if refined:
                forest.refine(marks)
            m = forest.mesh()
            cent = m.vertices[m.elements].mean(axis=1)
            d = np.hypot(cent[:, 0] - cx, cent[:, 1] - cy)
            merged = forest.derefine(d > 0.3)
            if not refined and merged == 0:
                break
        nc = forest.nc()
        sp = NCFESpace(nc, args.order)
        x = sp.dof_coords
        u = jnp.asarray(np.exp(-40 * ((x[:, 0] - cx) ** 2
                                      + (x[:, 1] - cy) ** 2)))
        print(f"step {step}: elements={nc.mesh.ne} "
              f"conforming dofs={sp.ndof_conf} hanging={nc.n_hanging} "
              f"max u={float(u.max()):.3f}")


if __name__ == "__main__":
    main()
