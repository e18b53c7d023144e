"""IMEX DG advection-diffusion (ex41 analog)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models.advection_diffusion import (
    DGAdvectionDiffusion,
)
from cardiac_ablation_ecm2.ops.dg_advection import project_l2


def vel(x):
    v = np.zeros(np.asarray(x).shape[:-1] + (2,))
    v[..., 0] = 1.0
    return v


def test_imex_matches_small_dt_explicit():
    """IMEX-RK2 with moderate dt ≈ fully explicit RK4 with small dt."""
    mesh = make_cartesian_2d(12, 12)
    fes = L2FESpace(mesh, 1)
    op = DGAdvectionDiffusion(
        fes, vel, epsilon=5e-3,
        inflow=lambda x: np.zeros(x.shape[:-1]), rel_tol=1e-12,
    )

    def u0(x):
        x = np.asarray(x)
        return np.exp(-((x[..., 0] - 0.4) ** 2 + (x[..., 1] - 0.5) ** 2) / 0.01)

    imex = ode.select("imex_rk2")
    rk4 = ode.select("rk4")

    @jax.jit
    def step_imex(u, t, dt):
        return imex.step(op, u, t, dt)

    @jax.jit
    def step_exp(u, t, dt):
        return rk4.step(op, u, t, dt)

    T = 0.04
    u_i = project_l2(fes, u0)
    t = 0.0
    for _ in range(8):                      # dt = 5e-3
        u_i, t = step_imex(u_i, t, T / 8)
    u_e = project_l2(fes, u0)
    t = 0.0
    for _ in range(40):                     # dt = 1e-3
        u_e, t = step_exp(u_e, t, T / 40)

    gf = geom_factors_for(fes)
    db = basis_for(fes)
    qi = eval_values(db, u_i.reshape(mesh.ne, fes.nd_elem))
    qe = eval_values(db, u_e.reshape(mesh.ne, fes.nd_elem))
    err = float(jnp.sqrt(jnp.sum(gf.wdet * (qi - qe) ** 2)))
    ref = float(jnp.sqrt(jnp.sum(gf.wdet * qe**2)))
    assert err < 2e-2 * ref, (err, ref)


def test_diffusion_smooths_and_advects():
    """Peak decays (diffusion) while the centroid advects (transport)."""
    mesh = make_cartesian_2d(16, 8, 2.0, 1.0)
    fes = L2FESpace(mesh, 1)
    op = DGAdvectionDiffusion(
        fes, vel, epsilon=2e-2,
        inflow=lambda x: np.zeros(x.shape[:-1]), rel_tol=1e-11,
    )
    imex = ode.select("imex_rk2")

    @jax.jit
    def step(u, t, dt):
        return imex.step(op, u, t, dt)

    def u0(x):
        x = np.asarray(x)
        return np.exp(-((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2) / 0.01)

    gf = geom_factors_for(fes)
    db = basis_for(fes)

    def stats(u):
        q = eval_values(db, u.reshape(mesh.ne, fes.nd_elem))
        m = jnp.sum(gf.wdet * q)
        cx = float(jnp.sum(gf.wdet * q * gf.x[..., 0]) / m)
        return float(jnp.max(q)), cx

    u = project_l2(fes, u0)
    p0, c0 = stats(u)
    t = 0.0
    for _ in range(20):
        u, t = step(u, t, 0.01)
    p1, c1 = stats(u)
    assert p1 < 0.7 * p0                    # diffusion decays the peak
    assert 0.15 < c1 - c0 < 0.25            # transported ~ v·T = 0.2
