"""Example 38: integration over implicit interfaces and subdomains
(reference examples/ex38.cpp analog; Algoim-style dimension-reduction
rules instead of moment fitting — fem/cutcells.py).

  python examples/ex38_cutcell.py --cpu -i surface2d -o 6
  python examples/ex38_cutcell.py --cpu -i volumetric3d -o 5
"""

import numpy as np
from common import setup_jax, standard_parser

CASES = {
    "surface2d": dict(
        phi=lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2),
        f=lambda x: 3 * x[..., 0] ** 2 - x[..., 1] ** 2,
        dim=2, surface_exact=2 * np.pi, volume_exact=None),
    "volumetric2d": dict(
        phi=lambda x: 1.0 - ((x[..., 0] / 1.5) ** 2 + (x[..., 1] / .75) ** 2),
        f=lambda x: np.ones(x.shape[:-1]),
        dim=2, surface_exact=7.26633616541076,
        volume_exact=9 * np.pi / 8),
    "surface3d": dict(
        phi=lambda x: 1.0 - (x ** 2).sum(axis=-1),
        f=lambda x: 4 - 3 * x[..., 0] ** 2 + 2 * x[..., 1] ** 2
        - x[..., 2] ** 2,
        dim=3, surface_exact=40 * np.pi / 3, volume_exact=None),
    "volumetric3d": dict(
        phi=lambda x: 1.0 - ((x[..., 0] / 1.5) ** 2 + (x[..., 1] / .75) ** 2
                             + (x[..., 2] / .5) ** 2),
        f=lambda x: np.ones(x.shape[:-1]),
        dim=3, surface_exact=9.90182151329315,
        volume_exact=4 * np.pi / 3 * 1.5 * .75 * .5),
}


def main():
    ap = standard_parser("cut-cell integration on implicit domains (ex38)")
    ap.add_argument("-i", "--inttype", default="surface2d",
                    choices=sorted(CASES))
    ap.add_argument("-n", type=int, default=8, help="elements per side")
    ap.add_argument("--depth", type=int, default=6)
    args = ap.parse_args()
    setup_jax(args)

    from cardiac_ablation_ecm2.fem.cutcells import (cut_surface_rule,
                                                        cut_volume_rule,
                                                        integrate)
    from cardiac_ablation_ecm2.mesh import (Mesh, make_cartesian_2d,
                                                make_cartesian_3d)

    case = CASES[args.inttype]
    n = args.n
    if case["dim"] == 2:
        mesh = make_cartesian_2d(n, n, 4.0, 4.0)
        shift = np.array([2.0, 2.0])
    else:
        mesh = make_cartesian_3d(n, n, n, 4.0, 4.0, 4.0)
        shift = np.array([2.0, 2.0, 2.0])
    mesh = Mesh(geom=mesh.geom, vertices=mesh.vertices - shift,
                elements=mesh.elements, attributes=mesh.attributes,
                boundary=mesh.boundary, bdr_attributes=mesh.bdr_attributes)

    order = max(args.order, 2)
    spts, swts = cut_surface_rule(mesh, case["phi"], order=order,
                                  depth=args.depth)
    sval = integrate(spts, swts, case["f"])
    print(f"Surface integral: {sval:.10f}  (exact {case['surface_exact']:.10f}"
          f", err {abs(sval - case['surface_exact']):.3e})")
    if case["volume_exact"] is not None:
        vpts, vwts = cut_volume_rule(mesh, case["phi"], order=order,
                                     depth=args.depth)
        vval = integrate(vpts, vwts, case["f"])
        print(f"Volume integral:  {vval:.10f}  (exact "
              f"{case['volume_exact']:.10f}, err "
              f"{abs(vval - case['volume_exact']):.3e})")


if __name__ == "__main__":
    main()
