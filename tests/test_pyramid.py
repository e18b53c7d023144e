"""Pyramid elements (order 1, rational vertex basis — LinearPyramidFE
analog): geometric exactness and Poisson convergence."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import (
    basis_for,
    geom_factors_for,
    restriction_for,
)
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d_pyramid
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def test_volume_positive_jacobians():
    mesh = make_cartesian_3d_pyramid(2, 3, 2, 2.0, 1.0, 1.0)
    fes = FESpace(mesh, 1)
    gf = geom_factors_for(fes)
    assert float(np.asarray(gf.det).min()) > 0
    assert np.isclose(float(np.asarray(gf.wdet).sum()), 2.0, atol=1e-12)


def test_linear_projection_exact():
    mesh = make_cartesian_3d_pyramid(2, 2, 2)
    fes = FESpace(mesh, 1)

    def f(x):
        x = np.asarray(x)
        return 1.0 + 2 * x[..., 0] - x[..., 1] + 0.5 * x[..., 2]

    u = project(fes, f)
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(u))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-12)


def _solve(n):
    mesh = make_cartesian_3d_pyramid(n, n, n)
    fes = FESpace(mesh, 1)

    def u_ex(x):
        return (np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
                * np.sin(np.pi * x[..., 2]))

    b = domain_lf(fes, lambda x: 3 * np.pi**2 * u_ex(x))
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = A.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    x, _ = cg(Aop, b * (1 - mask), rel_tol=1e-11, max_iter=3000)
    gf = geom_factors_for(fes)
    uq = np.asarray(eval_values(basis_for(fes), restriction_for(fes).mult(x)))
    ex = u_ex(np.asarray(gf.x))
    w = np.asarray(gf.wdet)
    return float(np.sqrt(np.sum(w * (uq - ex) ** 2)))


def test_poisson_converges():
    e1 = _solve(2)
    e2 = _solve(4)
    rate = np.log2(e1 / e2)
    assert rate > 1.7, (e1, e2, rate)   # order-1: L2 rate 2
