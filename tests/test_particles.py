"""Particle sets: locate/interpolate/advect (ParticleSet analog)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.particles import ParticleSet
from cardiac_ablation_ecm2.parallel.partition import partition_mesh


def test_locate_and_interpolate():
    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 3)
    u = project(fes, lambda x: x[..., 0] ** 3 + 2 * x[..., 1])
    rng = np.random.default_rng(0)
    pts = rng.random((50, 2)) * 0.98 + 0.01
    ps = ParticleSet(positions=pts)
    elem, ref = ps.locate(mesh)
    assert (elem >= 0).all()
    vals = ps.interpolate(fes, np.asarray(u), name="u")
    exact = pts[:, 0] ** 3 + 2 * pts[:, 1]
    assert np.abs(vals - exact).max() < 1e-10
    assert "u" in ps.fields


def test_advect_rigid_rotation():
    """Rotating velocity field (−y+c, x−c): particles orbit the center —
    radius conserved to RK4 accuracy."""
    mesh = make_cartesian_2d(8, 8)
    fes = FESpace(mesh, 2)

    def vx(x):
        return -(x[..., 1] - 0.5)

    def vy(x):
        return x[..., 0] - 0.5

    uvec = np.concatenate([np.asarray(project(fes, vx)),
                           np.asarray(project(fes, vy))])
    pts = np.array([[0.75, 0.5], [0.5, 0.7], [0.6, 0.6]])
    r0 = np.linalg.norm(pts - 0.5, axis=1)
    ps = ParticleSet(positions=pts.copy())
    ps.advect(fes, uvec, dt=0.05, steps=40, clamp=(0.01, 0.99))  # ~2 rad
    r1 = np.linalg.norm(ps.positions - 0.5, axis=1)
    assert np.abs(r1 - r0).max() < 1e-5
    # particles actually moved
    assert np.linalg.norm(ps.positions - pts, axis=1).min() > 0.1


def test_assign_partitions():
    mesh = make_cartesian_2d(4, 4)
    parts = partition_mesh(mesh, 4)
    pts = np.array([[0.1, 0.1], [0.9, 0.9], [5.0, 5.0]])   # last escapes
    ps = ParticleSet(positions=pts)
    pid = ps.assign_partitions(mesh, parts)
    assert pid[0] >= 0 and pid[1] >= 0 and pid[2] == -1
    assert pid[0] != pid[1]
