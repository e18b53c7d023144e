"""Navier-Stokes split-step solver (miniapps/fluids/navier analog):
Kovasznay-flow validation — the canonical NavierSolver test case."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.mesh import Mesh
from cardiac_ablation_ecm2.models.navier import NavierSolver

RE = 40.0
LAM = RE / 2 - np.sqrt(RE * RE / 4 + 4 * np.pi ** 2)


def kovasznay_u(x):
    x = np.asarray(x)
    ex = np.exp(LAM * x[..., 0])
    return np.stack(
        [1 - ex * np.cos(2 * np.pi * x[..., 1]),
         LAM / (2 * np.pi) * ex * np.sin(2 * np.pi * x[..., 1])], axis=-1)


def kov_mesh(nx=6, ny=5):
    m0 = make_cartesian_2d(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] = -0.5 + 2.5 * V[:, 0]
    V[:, 1] = -0.5 + 2.0 * V[:, 1]
    return Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                attributes=m0.attributes, boundary=m0.boundary,
                bdr_attributes=m0.bdr_attributes)


def test_kovasznay_steady_state_preserved():
    """Starting FROM the interpolated exact solution, 30 BDF2/EXT2 steps
    must stay at the interpolation-error level — any sign/term error in the
    convection, pressure, or projection sub-steps would drift or blow up."""
    ns = NavierSolver(mesh=kov_mesh(), order=4, kin_vis=1.0 / RE,
                      vel_bc=kovasznay_u, rel_tol=1e-10)
    u, p = ns.initial_state(kovasznay_u)
    err0 = ns.velocity_error(u, kovasznay_u)
    u, p = ns.run(dt=2e-3, nsteps=30, u0=kovasznay_u)
    err = ns.velocity_error(u, kovasznay_u)
    assert err < 2.0 * err0 + 1e-6, (err, err0)
    assert ns.div_norm(u) < 0.1


def test_kovasznay_approach_from_perturbed():
    """A perturbed start must decay back toward the steady solution (the
    mesh must resolve Kovasznay well so the steady discretization error is
    below the perturbation: order 4 on 6x5)."""
    ns = NavierSolver(mesh=kov_mesh(6, 5), order=4, kin_vis=1.0 / RE,
                      vel_bc=kovasznay_u, rel_tol=1e-9)

    def u_pert(x):
        u = kovasznay_u(x)
        x = np.asarray(x)
        bump = 0.2 * np.exp(-40 * ((x[..., 0] - 0.7) ** 2
                                   + (x[..., 1] - 0.5) ** 2))
        u = u + np.stack([bump, -bump], axis=-1)
        return u

    u0, _ = ns.initial_state(u_pert)
    err_start = ns.velocity_error(u0, kovasznay_u)
    u, p = ns.run(dt=5e-3, nsteps=100, u0=u_pert)
    err_end = ns.velocity_error(u, kovasznay_u)
    assert err_end < 0.5 * err_start, (err_start, err_end)
    assert err_end < 0.03


def test_navier_3d_dissipation_and_divergence():
    """3D run: a wall-vanishing divergence-free initial vortex decays
    monotonically (viscous dissipation) and stays discretely
    divergence-free through the 3D pressure projection."""
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d

    def u0(x):
        x = np.asarray(x)
        return np.stack([
            np.sin(np.pi * x[..., 0]) ** 2 * np.sin(2 * np.pi * x[..., 1]),
            -np.sin(2 * np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) ** 2,
            0 * x[..., 0],
        ], axis=-1)

    def wall(x):
        return np.zeros(np.asarray(x).shape[:-1] + (3,))

    ns = NavierSolver(make_cartesian_3d(5, 5, 2), order=2, kin_vis=0.05,
                      vel_bc=wall)
    zero = lambda x: 0 * np.asarray(x)[..., :3]
    dt = 0.005
    u, p = ns.initial_state(u0)
    kes = [ns.velocity_error(u, zero)]
    s1 = ns._make_step(dt, 1)
    s2 = ns._make_step(dt, 2)
    u_prev = u
    u, p = s1((u,), p, ns.u_bc, ns.b_f)
    kes.append(ns.velocity_error(u, zero))
    for _ in range(10):
        u_new, p = s2((u, u_prev), p, ns.u_bc, ns.b_f)
        u, u_prev = u_new, u
        kes.append(ns.velocity_error(u, zero))
    assert all(np.isfinite(kes))
    assert all(b < a for a, b in zip(kes, kes[1:])), kes   # dissipation
    assert kes[-1] > 0.3 * kes[0]                          # not blown away
    # the split scheme controls divergence weakly (pressure-space test
    # functions): bounded relative to the field, not pointwise zero
    assert ns.div_norm(u) < 0.8 * kes[-1]


def tg_u(x, t, nu):
    """Decaying 2D Taylor-Green vortex: exact Navier-Stokes solution
    (f = 0) — u = (cos πx sin πy, −sin πx cos πy)·e^{−2π²νt}."""
    x = np.asarray(x)
    F = np.exp(-2 * np.pi**2 * nu * t)
    return np.stack(
        [np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
         -np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])],
        axis=-1) * F


def test_taylor_green_temporal_convergence_rate():
    """Cold-start temporal convergence on the decaying Taylor-Green vortex
    (the reference validates NavierSolver with convergence rates —
    miniapps/fluids/tests/).  BDF2/EXT2 + rotational pressure correction
    should show ~2nd-order velocity error in dt; a first-order-locked
    splitting would show rate ≈ 1."""
    nu = 0.05
    T = 0.4
    m = make_cartesian_2d(4, 4)
    errs = []
    for nsteps in (8, 16, 32):
        ns = NavierSolver(mesh=m, order=6, kin_vis=nu, rel_tol=1e-12)
        u, p = ns.run(dt=T / nsteps, nsteps=nsteps,
                      u0=lambda x: tg_u(x, 0.0, nu),
                      vel_bc_t=lambda x, t: tg_u(x, t, nu))
        errs.append(ns.velocity_error(u, lambda x: tg_u(x, T, nu)))
    r1 = np.log2(errs[0] / errs[1])
    r2 = np.log2(errs[1] / errs[2])
    assert r2 > 1.6, (errs, r1, r2)
    assert errs[2] < errs[0] / 8
