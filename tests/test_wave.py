"""Wave equation (ex23 analog): standing-mode frequency and energy
conservation under Newmark average acceleration."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import l2_error, project
from cardiac_ablation_ecm2.linalg.ode2 import select2
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models import wave


def test_standing_wave_period():
    """u = cos(ωt) sin(πx) sin(πy), ω = π√2: after one period the solution
    must return to its initial state (2nd-order accuracy)."""
    mesh = make_cartesian_2d(16, 16)
    fes = FESpace(mesh, 2)
    op = wave.WaveOperator(fes, c2=1.0, rel_tol=1e-12)
    step = wave.make_stepper(op, select2("newmark"))

    def u0(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    omega = np.pi * np.sqrt(2.0)
    period = 2 * np.pi / omega
    u = project(fes, u0)
    v = jnp.zeros_like(u)
    n = 200
    dt = period / n
    t = 0.0
    for _ in range(n):
        u, v, t = step(u, v, t, dt)
    err = float(l2_error(fes, u, u0))
    assert err < 5e-3, err


def test_energy_conservation():
    """Newmark (β=1/4) conserves the discrete energy E = ½(v,Mv) + ½(u,Ku)."""
    mesh = make_cartesian_2d(10, 10)
    fes = FESpace(mesh, 2)
    op = wave.WaveOperator(fes, c2=1.0, rel_tol=1e-13)
    step = wave.make_stepper(op, select2("newmark"))

    def u0(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])

    u = project(fes, u0)
    v = jnp.zeros_like(u)

    def energy(u, v):
        uz = op._z(u)
        Ku = op._apply(op.M_qd, op.K_qd, uz, 0.0, 1.0)
        Mv = op._apply(op.M_qd, op.K_qd, op._z(v), 1.0, 0.0)
        return 0.5 * float(jnp.vdot(v, Mv)) + 0.5 * float(jnp.vdot(uz, Ku))

    E0 = energy(u, v)
    t = 0.0
    for _ in range(50):
        u, v, t = step(u, v, t, 0.01)
    E1 = energy(u, v)
    assert abs(E1 - E0) < 1e-8 * max(abs(E0), 1), (E0, E1)
