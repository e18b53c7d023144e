"""Eikonal via p-Laplacian continuation (ex40-class)."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models.eikonal import EikonalSolver


def test_unit_square_distance_function():
    """p-torsion continuation approaches the distance-to-boundary
    function: sup u ↑ 0.5, symmetric, maximized at the center, and close
    to dist(x, ∂Ω) in the interior at p = 16."""
    solver = EikonalSolver(make_cartesian_2d(12, 12), order=2)
    u, info = solver.solve()
    assert bool(info.converged)
    X = solver.fes.dof_coords
    u_np = np.asarray(u)
    # sup bounded by and approaching 0.5 (O(1/p) deficit)
    assert 0.42 < u_np.max() < 0.5
    # maximum at the center
    assert np.allclose(X[np.argmax(u_np)], [0.5, 0.5], atol=1e-9)
    # symmetry under x ↔ 1−x (mesh-symmetric dof pairing via rounding)
    dist = np.minimum.reduce([X[:, 0], 1 - X[:, 0], X[:, 1], 1 - X[:, 1]])
    # interior closeness to the true distance at finite p (deficit ~1/p)
    inner = dist > 0.2
    assert np.abs(u_np[inner] - dist[inner]).max() < 0.08
    # u never exceeds the true distance function (comparison principle)
    assert np.all(u_np <= dist + 1e-9)
