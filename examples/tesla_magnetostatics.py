"""Tesla-class magnetostatics: curl(ν curl A) + εA = J on H(curl), then
B = curl A in H(div) (reference miniapps/electromagnetics/tesla.cpp)."""

import numpy as np

from common import setup_jax, standard_parser


def main():
    ap = standard_parser("Magnetostatic vector potential + B recovery")
    ap.add_argument("-n", "--ncell", type=int, default=3)
    args = ap.parse_args()
    setup_jax(args)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.vecfe import (
        build_nd_operator,
        discrete_curl,
        discrete_divergence,
        vecfe_linear_form,
    )

    n = args.ncell
    mesh = make_cartesian_3d(n, n, n)
    nd = NDSpace(mesh)
    rt = RTSpace(mesh)

    # curl(curl A) + eps A = J; J = a z-directed loop-ish current
    eps = 1e-2
    op = build_nd_operator(nd, mass_coeff=eps, curlcurl_coeff=1.0, nq1d=3)

    def J(x):
        r = np.stack([x[..., 0] - 0.5, x[..., 1] - 0.5], axis=-1)
        jz = np.exp(-20 * np.sum(r ** 2, axis=-1))
        out = np.zeros(x.shape)
        out[..., 2] = jz
        return out

    b = vecfe_linear_form(op, J)
    A, info = cg(op.mult, b, M=lambda r_: r_ / op.diagonal(),
                 rel_tol=1e-11, max_iter=4000)
    print(f"vector-potential solve: ndof={nd.ndof} iters={info.iterations}")

    C = discrete_curl(nd, rt)
    B = C(A)
    D = discrete_divergence(rt)
    divB = np.asarray(D(B))
    print(f"|B|_max = {float(jnp.abs(B).max()):.4e}   "
          f"max |div B| = {np.abs(divB).max():.3e} (exact de Rham zero)")
    assert np.abs(divB).max() < 1e-12


if __name__ == "__main__":
    main()
