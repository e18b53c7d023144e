"""ex31 analog: anisotropic definite Maxwell in 1D/2D/3D.

Solves curl curl E + sigma E = f with a full 3x3 anisotropic sigma and a
3-component E on a mesh of dimension 1, 2, or 3, using the restricted
H(curl) spaces ND_R1D / ND_R2D in 1D/2D and the standard ND space in 3D
(reference: /root/reference/examples/ex31.cpp; fe_coll.hpp:554-672).

Usage:
  python examples/ex31_aniso_maxwell.py -d 1 -o 2 -n 16
  python examples/ex31_aniso_maxwell.py -d 2 -o 2 -n 8 --tri
  python examples/ex31_aniso_maxwell.py -d 3 -o 1 -n 4
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)
if "--cpu" in sys.argv:
    # must precede the first backend use (the imports below)
    jax.config.update("jax_platforms", "cpu")

from cardiac_ablation_ecm2.linalg.solvers import cg  # noqa: E402
from cardiac_ablation_ecm2.mesh import (  # noqa: E402
    make_cartesian_2d,
    make_cartesian_3d,
)
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_2d_tri  # noqa: E402
from cardiac_ablation_ecm2.ops.vecfe import (  # noqa: E402
    build_nd_operator,
    vecfe_linear_form,
)
from cardiac_ablation_ecm2.ops.vecfe_r import (  # noqa: E402
    NDR1DSpace,
    NDR2DSpace,
    build_nd_r1d_operator,
    build_nd_r2d_operator,
)

SIGMA = np.array([[2.0, 0.5, 0.0], [0.5, 2.0, 0.5], [0.0, 0.5, 2.0]])


def exact(dim):
    """Manufactured E with zero tangential trace on the unit box, and
    f = curl curl E + sigma E (hand-derived)."""
    pi = np.pi
    if dim == 1:
        def E(x):
            px = pi * x[..., 0]
            return np.stack(
                [np.cos(px), np.sin(px), np.sin(2 * px)], axis=-1)

        def f(x):
            px = pi * x[..., 0]
            cc = np.stack([np.zeros_like(px), pi**2 * np.sin(px),
                           4 * pi**2 * np.sin(2 * px)], axis=-1)
            return cc + E(x) @ SIGMA.T
    elif dim == 2:
        def E(x):
            px, py = pi * x[..., 0], pi * x[..., 1]
            return np.stack(
                [np.sin(py), np.sin(px), np.sin(px) * np.sin(py)], axis=-1)

        def f(x):
            px, py = pi * x[..., 0], pi * x[..., 1]
            cc = np.stack([pi**2 * np.sin(py), pi**2 * np.sin(px),
                           2 * pi**2 * np.sin(px) * np.sin(py)], axis=-1)
            return cc + E(x) @ SIGMA.T
    else:
        def E(x):
            px, py, pz = pi * x[..., 0], pi * x[..., 1], pi * x[..., 2]
            return np.stack(
                [np.sin(py) * np.sin(pz), np.sin(px) * np.sin(pz),
                 np.sin(px) * np.sin(py)], axis=-1)

        def f(x):
            # curl curl E = 2 pi^2 E for this E (each component biharmonic
            # in the two transverse coordinates)
            return 2 * pi**2 * E(x) + E(x) @ SIGMA.T
    return E, f


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dim", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-n", type=int, default=8, help="elements per axis")
    ap.add_argument("--tri", action="store_true",
                    help="2D: triangles instead of quads")
    ap.add_argument("--cpu", action="store_true", help="force CPU platform")
    args = ap.parse_args()

    E_ex, f_ex = exact(args.dim)
    if args.dim == 1:
        sp = NDR1DSpace(np.linspace(0.0, 1.0, args.n + 1), args.order)
        op = build_nd_r1d_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0)
    elif args.dim == 2:
        mesh = (make_cartesian_2d_tri(args.n, args.n) if args.tri
                else make_cartesian_2d(args.n, args.n))
        sp = NDR2DSpace(mesh, args.order)
        op = build_nd_r2d_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0)
    else:
        from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO

        mesh = make_cartesian_3d(args.n, args.n, args.n)
        sp = NDSpaceHO(mesh, args.order)
        op = build_nd_operator(sp, mass_coeff=SIGMA, curlcurl_coeff=1.0,
                               nq1d=args.order + 2)

    b = vecfe_linear_form(op, f_ex)
    ess = sp.essential_dofs()
    keep = np.ones(op.ndof)
    keep[np.asarray(ess)] = 0.0
    keep = jnp.asarray(keep)

    def A(x):
        return op.mult(x * keep) * keep + x * (1 - keep)

    d = jnp.where(keep > 0, op.diagonal(), 1.0)
    x, info = cg(A, b * keep, M=lambda r: r / d, rel_tol=1e-10,
                 max_iter=10000)

    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = op._pre(x[op.gather]) if op.tf is not None else \
        x[op.gather] * op.signs
    vals = jnp.einsum("eqnc,en->eqc", Bq, e)
    ex = jnp.asarray(E_ex(np.asarray(op.gf.x)))
    err = float(jnp.sqrt(jnp.sum(op.gf.wdet * jnp.sum((vals - ex) ** 2, -1))))
    print(f"dim={args.dim} order={args.order} n={args.n} "
          f"ndof={op.ndof} iters={info.iterations} ||E-E_h||_L2={err:.4e}")


if __name__ == "__main__":
    main()
