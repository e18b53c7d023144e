"""Wedge (prism) elements: H1_WedgeElement analog — projection exactness,
geometric volume, Poisson convergence with Dirichlet side walls."""

import numpy as np
import pytest
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
from cardiac_ablation_ecm2.mesh import make_cartesian_3d_prism
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


@pytest.mark.parametrize("p", [1, 2, 3])
def test_projection_exact(p):
    """An order-p polynomial projects exactly (nodal interpolation via the
    entity-key dof numbering must be conforming across tri/quad faces)."""
    mesh = make_cartesian_3d_prism(2, 2, 2)
    fes = FESpace(mesh, p)

    def f(x):
        x = np.asarray(x)
        out = x[..., 0] ** p + 0.3 * x[..., 1] - 0.7 * x[..., 2]
        if p >= 2:
            out = out + x[..., 0] * x[..., 2] ** (p - 1)
        return out

    u = project(fes, f)
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(u))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_volume_and_surface():
    mesh = make_cartesian_3d_prism(3, 2, 2, 2.0, 1.0, 1.0)
    fes = FESpace(mesh, 2)
    gf = geom_factors_for(fes)
    assert np.isclose(float(np.asarray(gf.wdet).sum()), 2.0, atol=1e-12)


def _solve_poisson(n, p):
    """-Δu = f on the unit cube, u = sin(πx)sin(πy)cos(πz):
    u = 0 on side walls (Dirichlet), ∂u/∂n = 0 at z ∈ {0,1} (natural) —
    exactly the BCs the prism mesh's side-wall-only boundary represents."""
    mesh = make_cartesian_3d_prism(n, n, n)
    fes = FESpace(mesh, p)

    def u_ex(x):
        return (np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
                * np.cos(np.pi * x[..., 2]))

    b = domain_lf(fes, lambda x: 3 * np.pi**2 * u_ex(x))
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = A.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    x, info = cg(Aop, b * (1 - mask), rel_tol=1e-11, max_iter=3000)
    gf = geom_factors_for(fes)
    uq = np.asarray(eval_values(basis_for(fes), restriction_for(fes).mult(x)))
    ex = u_ex(np.asarray(gf.x))
    w = np.asarray(gf.wdet)
    return float(np.sqrt(np.sum(w * (uq - ex) ** 2)))


def test_poisson_converges_p2():
    e1 = _solve_poisson(2, 2)
    e2 = _solve_poisson(4, 2)
    rate = np.log2(e1 / e2)
    assert rate > 2.5, (e1, e2, rate)


def test_essential_dofs_side_walls_only():
    mesh = make_cartesian_3d_prism(2, 2, 2)
    fes = FESpace(mesh, 2)
    ess = fes.essential_dofs(None)
    X = fes.dof_coords[ess]
    on_side = (
        np.isclose(X[:, 0], 0) | np.isclose(X[:, 0], 1)
        | np.isclose(X[:, 1], 0) | np.isclose(X[:, 1], 1)
    )
    assert on_side.all()
    # every side-wall dof is constrained
    Xall = fes.dof_coords
    side = (
        np.isclose(Xall[:, 0], 0) | np.isclose(Xall[:, 0], 1)
        | np.isclose(Xall[:, 1], 0) | np.isclose(Xall[:, 1], 1)
    )
    assert len(ess) == side.sum()
