"""BR2-stabilized DG diffusion: SPD operator, ex14-style convergence."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops.dg_diffusion import DGDiffusionBR2
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def _solve(n, p):
    mesh = make_cartesian_2d(n, n)
    fes = L2FESpace(mesh, p)
    op = DGDiffusionBR2(fes)

    def f(x):
        return 2 * np.pi**2 * np.sin(np.pi * x[..., 0]) * np.sin(
            np.pi * x[..., 1]
        )

    b = domain_lf(fes, f) + op.dirichlet_rhs(lambda x: 0.0 * x[..., 0])
    x, info = cg(op.mult, b, rel_tol=1e-12, max_iter=2000)

    gf = geom_factors_for(fes)
    uq = eval_values(basis_for(fes), jnp.reshape(x, (mesh.ne, fes.nd_elem)))
    xq = np.asarray(gf.x)
    ex = np.sin(np.pi * xq[..., 0]) * np.sin(np.pi * xq[..., 1])
    err = float(
        np.sqrt(np.sum(np.asarray(gf.wdet) * (np.asarray(uq) - ex) ** 2))
    )
    return err


def test_br2_symmetric_psd():
    mesh = make_cartesian_2d(3, 3)
    fes = L2FESpace(mesh, 2)
    op = DGDiffusionBR2(fes)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = jnp.asarray(rng.standard_normal(fes.ndof))
        y = jnp.asarray(rng.standard_normal(fes.ndof))
        axy = float(jnp.vdot(op.mult(x), y))
        ayx = float(jnp.vdot(op.mult(y), x))
        assert abs(axy - ayx) < 1e-10 * max(1.0, abs(axy))
        assert float(jnp.vdot(op.mult(x), x)) > 0


def test_br2_converges_order_p1():
    p = 2
    e1 = _solve(4, p)
    e2 = _solve(8, p)
    rate = np.log2(e1 / e2)
    assert rate > p + 0.5, (e1, e2, rate)


def test_br2_matches_sipg():
    """BR2 and SIPG solve the same problem: solutions agree to discretization
    accuracy (both converge to the same u)."""
    from cardiac_ablation_ecm2.ops.dg_diffusion import DGDiffusion

    mesh = make_cartesian_2d(8, 8)
    fes = L2FESpace(mesh, 2)

    def f(x):
        return 2 * np.pi**2 * np.sin(np.pi * x[..., 0]) * np.sin(
            np.pi * x[..., 1]
        )

    sols = []
    for op in (DGDiffusionBR2(fes), DGDiffusion(fes)):
        b = domain_lf(fes, f) + op.dirichlet_rhs(lambda x: 0.0 * x[..., 0])
        x, _ = cg(op.mult, b, rel_tol=1e-12, max_iter=3000)
        sols.append(np.asarray(x))
    scale = np.abs(sols[1]).max()
    assert np.abs(sols[0] - sols[1]).max() < 5e-3 * scale
