"""DG advection (ex9 analog): free-stream preservation, upwind transport
accuracy, and conservation."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops.dg_advection import DGAdvection, project_l2
from cardiac_ablation_ecm2.fem.build import geom_factors_for, basis_for
from cardiac_ablation_ecm2.fem.quadinterp import eval_values


def vel_const(x):
    v = np.zeros(np.asarray(x).shape[:-1] + (2,))
    v[..., 0] = 1.0
    v[..., 1] = 0.5
    return v


def test_free_stream_preservation():
    """u ≡ 1 with matching inflow is an exact steady state of the upwind DG
    operator (machine-precision consistency of volume vs face terms)."""
    mesh = make_cartesian_2d(5, 4)
    fes = L2FESpace(mesh, 2)
    op = DGAdvection(fes, vel_const, inflow=lambda x: np.ones(x.shape[:-1]))
    u1 = jnp.ones(fes.ndof)
    r = np.asarray(op.rhs(u1))
    assert np.abs(r).max() < 1e-12, np.abs(r).max()
    du = np.asarray(op.mult(0.0, u1))
    assert np.abs(du).max() < 1e-10


def test_gaussian_transport():
    """Advect a Gaussian diagonally; compare against exact translation."""
    mesh = make_cartesian_2d(24, 24)
    fes = L2FESpace(mesh, 2)

    def u0(x, t=0.0):
        x = np.asarray(x)
        cx, cy = 0.3 + t, 0.3 + 0.5 * t
        return np.exp(-(((x[..., 0] - cx) ** 2 + (x[..., 1] - cy) ** 2)
                        / 0.005))

    op = DGAdvection(fes, vel_const, inflow=lambda x: np.zeros(x.shape[:-1]))
    solver = ode.select("rk3_ssp")
    import jax

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    u = project_l2(fes, u0)
    t, dt, T = 0.0, 0.4 / 24 / 4, 0.3
    n = int(round(T / dt))
    for _ in range(n):
        u, t = step(u, t, dt)

    # L2 error vs translated exact solution
    gf = geom_factors_for(fes)
    db = basis_for(fes)
    uq = np.asarray(eval_values(db, jnp.reshape(u, (mesh.ne, fes.nd_elem))))
    ex = u0(np.asarray(gf.x), float(t))
    err = np.sqrt(np.sum(np.asarray(gf.wdet) * (uq - ex) ** 2))
    assert err < 2e-3, err


def test_conservation_interior():
    """With zero inflow and no outflow crossing yet, total mass is conserved
    up to boundary fluxes (track ∫u before the pulse reaches the boundary)."""
    mesh = make_cartesian_2d(16, 16)
    fes = L2FESpace(mesh, 1)

    def u0(x):
        x = np.asarray(x)
        return np.exp(-(((x[..., 0] - 0.35) ** 2 + (x[..., 1] - 0.35) ** 2)
                        / 0.004))

    op = DGAdvection(fes, vel_const, inflow=lambda x: np.zeros(x.shape[:-1]))
    solver = ode.select("rk4")
    import jax

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    gf = geom_factors_for(fes)
    db = basis_for(fes)

    def total(u):
        uq = eval_values(db, jnp.reshape(u, (mesh.ne, fes.nd_elem)))
        return float(jnp.sum(gf.wdet * uq))

    u = project_l2(fes, u0)
    m0 = total(u)
    t, dt = 0.0, 0.002
    for _ in range(25):
        u, t = step(u, t, dt)
    m1 = total(u)
    assert abs(m1 - m0) < 1e-10 * max(1.0, abs(m0)) + 1e-12 or abs(
        m1 - m0
    ) < 1e-8, (m0, m1)


def test_periodic_advection_wraps():
    """Periodic mesh: DG advection wraps around and returns after one period
    (the ex9 periodic-square configuration)."""
    import jax
    from cardiac_ablation_ecm2.mesh import make_periodic_cartesian_2d

    mesh = make_periodic_cartesian_2d(16, 3, 1.0, 0.25, periodic=(True, False))
    assert mesh.nbe > 0              # y-walls remain, x is periodic
    fes = L2FESpace(mesh, 1)

    def vx(x):
        v = np.zeros(np.asarray(x).shape[:-1] + (2,))
        v[..., 0] = 1.0
        return v

    op = DGAdvection(fes, vx, inflow=lambda x: np.zeros(x.shape[:-1]))
    solver = ode.select("rk3_ssp")

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    def u0(x):
        x = np.asarray(x)
        return np.exp(-((x[..., 0] - 0.5) ** 2) / 0.01)

    u = project_l2(fes, u0)
    gf = geom_factors_for(fes)
    db = basis_for(fes)

    def l2err(u):
        q = eval_values(db, jnp.reshape(u, (mesh.ne, fes.nd_elem)))
        ex = u0(np.asarray(gf.x))
        return float(jnp.sqrt(jnp.sum(gf.wdet * (q - ex) ** 2)))

    t, n = 0.0, 400
    dt = 1.0 / n
    for _ in range(n):                # exactly one period
        u, t = step(u, t, dt)
    err = l2err(u)
    ref = float(jnp.sqrt(jnp.sum(gf.wdet * u0(np.asarray(gf.x)) ** 2)))
    assert err < 0.25 * ref, (err, ref)   # pulse returned (upwind diffusion)
    # mass exactly conserved (no open boundary in x)
    q = eval_values(db, jnp.reshape(u, (mesh.ne, fes.nd_elem)))
    m1 = float(jnp.sum(gf.wdet * q))
    u0v = project_l2(fes, u0)
    q0 = eval_values(db, jnp.reshape(u0v, (mesh.ne, fes.nd_elem)))
    m0 = float(jnp.sum(gf.wdet * q0))
    assert abs(m1 - m0) < 1e-9 * max(abs(m0), 1)


def test_free_stream_tet_mesh():
    """DG face machinery on tetrahedra (triangle faces, all orientations)."""
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d_tet

    mesh = make_cartesian_3d_tet(2, 2, 2)
    fes = L2FESpace(mesh, 1)

    def vel3(x):
        v = np.zeros(np.asarray(x).shape[:-1] + (3,))
        v[..., 0] = 0.7
        v[..., 1] = -0.4
        v[..., 2] = 0.2
        return v

    op = DGAdvection(fes, vel3, inflow=lambda x: np.ones(x.shape[:-1]))
    u1 = jnp.ones(fes.ndof)
    r = np.asarray(op.rhs(u1))
    assert np.abs(r).max() < 1e-12, np.abs(r).max()
