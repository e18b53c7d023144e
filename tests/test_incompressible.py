"""Incompressible neo-Hookean (ex19 analog): (u,p) Lagrangian saddle
system via GMRES-Newton on jax.grad residuals."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.models.incompressible import (
    IncompressibleHyperelastic,
)


def test_uniaxial_stretch_3d():
    """Roller BCs + prescribed stretch λ: the exact solution is the
    homogeneous incompressible deformation F = diag(λ, λ^-½, λ^-½)."""
    lam = 1.2
    mesh = make_cartesian_3d(2, 2, 2)
    prob = IncompressibleHyperelastic(
        mesh, order=2, mu=1.0,
        ess=[(0, [5], 0.0), (0, [3], lam - 1.0),
             (1, [2], 0.0), (2, [1], 0.0)])
    x, info = prob.solve(rel_tol=1e-10)
    assert bool(info.converged)
    jmin, jmax = prob.deformation_stats(x)
    assert abs(jmin - 1) < 1e-6 and abs(jmax - 1) < 1e-6
    ns = prob.ns
    X = prob.sfes.dof_coords
    top = np.nonzero(np.abs(X[:, 1] - 1) < 1e-12)[0]
    uy = np.asarray(x[ns:2 * ns])
    assert np.allclose(uy[top], 1 / np.sqrt(lam) - 1, atol=1e-6)


def test_shear_2d_weak_incompressibility():
    """2D shear with clamped bottom: J = 1 holds weakly against the P1
    pressure space — total volume is preserved exactly even though the
    deformation is inhomogeneous (pointwise J deviates on coarse meshes)."""
    mesh = make_cartesian_2d(3, 3)
    prob = IncompressibleHyperelastic(
        mesh, order=2, mu=1.0,
        ess=[(0, [1], 0.0), (1, [1], 0.0),       # clamp bottom
             (0, [3], 0.3), (1, [3], 0.0)])      # shear top
    x, info = prob.solve(rel_tol=1e-9)
    assert bool(info.converged)
    # weak constraint with q = 1: ∫ (J − 1) = 0 (volume preservation)
    import jax.numpy as jnp

    F = prob._grad_u(x[: prob.nu]) + jnp.eye(2)
    J = jnp.linalg.det(F)
    dvol = float(jnp.sum(prob.gf.wdet * (J - 1.0)))
    assert abs(dvol) < 1e-9, dvol
    jmin, jmax = prob.deformation_stats(x)
    assert 0.5 < jmin <= jmax < 1.6            # bounded pointwise deviation
