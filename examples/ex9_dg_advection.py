"""Example 9: DG advection with explicit RK (reference examples/ex9.cpp).

  python examples/ex9_dg_advection.py -o 2 --steps 200
"""

import numpy as np

from common import load_mesh, setup_jax, standard_parser


def main():
    ap = standard_parser("DG advection of a Gaussian pulse, upwind fluxes")
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("-s", "--solver", default="rk3_ssp")
    args = ap.parse_args()
    setup_jax(args)

    import jax

    from cardiac_ablation_ecm2.fem.fespace import L2FESpace
    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.ops.dg_advection import DGAdvection, project_l2

    mesh = load_mesh(args, "inline-quad-24")
    fes = L2FESpace(mesh, args.order)

    def vel(x):
        v = np.zeros(np.asarray(x).shape[:-1] + (mesh.dim,))
        v[..., 0] = 1.0
        v[..., 1] = 0.5
        return v

    op = DGAdvection(fes, vel, inflow=lambda x: np.zeros(x.shape[:-1]))
    solver = ode.select(args.solver)

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    def u0(x):
        x = np.asarray(x)
        return np.exp(-((x[..., 0] - 0.3) ** 2 + (x[..., 1] - 0.3) ** 2) / 0.005)

    u = project_l2(fes, u0)
    t = 0.0
    for k in range(args.steps):
        u, t = step(u, t, args.dt)
    print(f"ndof={fes.ndof}  t={float(t):.4f}  "
          f"u in [{float(u.min()):.4f}, {float(u.max()):.4f}]")


if __name__ == "__main__":
    main()
