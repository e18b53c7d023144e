"""Structured Cartesian fast path vs the generic unstructured machinery."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace, StructuredRestriction
from cardiac_ablation_ecm2.fem.build import restriction_for
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator
from cardiac_ablation_ecm2.ops.linearform import domain_lf
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.linalg.smoothers import jacobi


@pytest.mark.parametrize("dim,p", [(2, 1), (2, 3), (3, 2)])
def test_structured_restriction_matches_gather(dim, p):
    n = (4, 3) if dim == 2 else (3, 2, 2)
    mesh = make_cartesian_2d(*n) if dim == 2 else make_cartesian_3d(*n)
    fes = CartesianFESpace(mesh, p, n)
    R = fes.restriction
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.random(fes.ndof_scalar))
    # structured gather equals formula gather_map indexing
    E1 = np.asarray(R.mult(u))
    E2 = np.asarray(u)[fes.gather_map]
    assert np.array_equal(E1, E2)
    # transpose is the exact adjoint
    E = jnp.asarray(rng.random((R.ne, R.nd)))
    lhs = float(jnp.vdot(R.mult(u), E))
    rhs = float(jnp.vdot(u, R.mult_transpose(E)))
    assert np.isclose(lhs, rhs, rtol=1e-13)


@pytest.mark.parametrize("dim", [2, 3])
def test_cartesian_poisson_matches_generic(dim):
    n = (8, 8) if dim == 2 else (4, 4, 4)
    mesh = make_cartesian_2d(*n) if dim == 2 else make_cartesian_3d(*n)
    p = 2

    def rhs_f(x):
        x = np.asarray(x)
        out = np.ones(x.shape[:-1])
        for d in range(dim):
            out = out * np.sin(np.pi * x[..., d])
        return out

    def solve(fes):
        A = ConstrainedOperator.wrap(
            BilinearForm(fes).add_domain_integrator("diffusion")
            .assemble().operator(),
            fes.essential_dofs(),
        )
        b = domain_lf(fes, rhs_f)
        b = b.at[jnp.asarray(fes.essential_dofs())].set(0.0)
        x, info = cg(A.mult, b, M=jacobi(A.diagonal()), rel_tol=1e-12,
                     max_iter=2000)
        return x, int(info.iterations), float(jnp.vdot(x, b))

    fes_g = FESpace(mesh, p)
    fes_c = CartesianFESpace(mesh, p, n)
    assert fes_c.ndof_scalar == fes_g.ndof_scalar
    xg, itg, eg = solve(fes_g)
    xc, itc, ec = solve(fes_c)
    # same discrete problem in a different dof ordering: identical energy and
    # iteration count
    assert abs(itg - itc) <= 1
    assert np.isclose(eg, ec, rtol=1e-10), (eg, ec)
    # dof_coords based comparison: interpolate both onto coordinates
    order_g = np.lexsort(np.round(fes_g.dof_coords.T, 9))
    order_c = np.lexsort(np.round(fes_c.dof_coords.T, 9))
    assert np.allclose(
        np.asarray(xg)[order_g], np.asarray(xc)[order_c], atol=1e-9
    )


def test_cartesian_essential_dofs():
    n = (3, 3, 3)
    mesh = make_cartesian_3d(*n)
    fes = CartesianFESpace(mesh, 2, n)
    ess = fes.essential_dofs([1])     # z = 0 face
    assert np.allclose(fes.dof_coords[ess][:, 2], 0.0)
    assert len(ess) == 7 * 7
    ess_x1 = fes.essential_dofs([3])  # x = 1
    assert np.allclose(fes.dof_coords[ess_x1][:, 0], 1.0)
    ess_all = fes.essential_dofs()
    assert len(ess_all) == 7**3 - 5**3
