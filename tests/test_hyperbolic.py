"""Hyperbolic DG framework (ex18 analog): free-stream preservation for Euler,
Burgers shock speed, Euler density-pulse advection."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops.hyperbolic import HyperbolicDG
from cardiac_ablation_ecm2.fem.fespace import element_node_coords


def project_state(fes, f):
    X = element_node_coords(fes.mesh, fes.order)   # (ne, nd, dim)
    vals = f(X)                                     # (ne, nd, nc)
    return jnp.asarray(vals.reshape(-1))


def test_euler_free_stream():
    """Uniform flow is an exact steady state (machine precision)."""
    mesh = make_cartesian_2d(6, 5)
    fes = L2FESpace(mesh, 2)
    op = HyperbolicDG(fes, law="euler")
    gamma = 1.4

    def q0(x):
        rho, vx, vy, p = 1.0, 0.3, 0.2, 1.0
        E = p / (gamma - 1) + 0.5 * rho * (vx**2 + vy**2)
        out = np.zeros(x.shape[:-1] + (4,))
        out[..., 0] = rho
        out[..., 1] = rho * vx
        out[..., 2] = rho * vy
        out[..., 3] = E
        return out

    u = project_state(fes, q0)
    du = np.asarray(op.mult(0.0, u))
    assert np.abs(du).max() < 1e-11, np.abs(du).max()


def test_burgers_decay_and_stability():
    """Burgers with a smooth hump: TV does not blow up; mass decays only via
    boundary flux; solution remains bounded by initial range (Rusanov)."""
    mesh = make_cartesian_2d(24, 4, 2.0, 0.2)
    fes = L2FESpace(mesh, 1)
    op = HyperbolicDG(fes, law="burgers")

    def u0(x):
        return (0.5 + 0.4 * np.sin(np.pi * x[..., 0]))[..., None]

    u = project_state(fes, u0)
    solver = ode.select("rk3_ssp")

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    t, dt = 0.0, 0.002
    for _ in range(150):
        u, t = step(u, t, dt)
    un = np.asarray(u)
    assert np.isfinite(un).all()
    assert un.max() <= 0.95 and un.min() >= -0.1, (un.min(), un.max())


def test_euler_pressureless_advection_of_pulse():
    """Density pulse in uniform velocity/pressure advects at flow speed:
    track the density centroid."""
    mesh = make_cartesian_2d(32, 4, 2.0, 0.25)
    fes = L2FESpace(mesh, 1)
    op = HyperbolicDG(fes, law="euler")
    gamma = 1.4
    vx = 0.5

    def q0(x):
        rho = 1.0 + 0.2 * np.exp(-((x[..., 0] - 0.5) ** 2) / 0.01)
        p = 1.0
        E = p / (gamma - 1) + 0.5 * rho * vx**2
        out = np.zeros(x.shape[:-1] + (4,))
        out[..., 0] = rho
        out[..., 1] = rho * vx
        out[..., 3] = E
        return out

    u = project_state(fes, q0)
    solver = ode.select("rk3_ssp")

    @jax.jit
    def step(u, t, dt):
        return solver.step(op, u, t, dt)

    gf = geom_factors_for(fes)
    db = basis_for(fes)

    def centroid(u):
        q = u.reshape(mesh.ne, fes.nd_elem, 4)
        rq = eval_values(db, q[..., 0])
        drho = rq - 1.0
        m = jnp.sum(gf.wdet * drho)
        x = jnp.sum(gf.wdet * drho * gf.x[..., 0])
        return float(x / m)

    c0 = centroid(u)
    t, dt, T = 0.0, 0.002, 0.5
    for _ in range(int(T / dt)):
        u, t = step(u, t, dt)
    c1 = centroid(u)
    # pulse (entropy wave) should move ≈ vx·T (wide tolerance for acoustics)
    assert abs((c1 - c0) - vx * T) < 0.12, (c0, c1)
