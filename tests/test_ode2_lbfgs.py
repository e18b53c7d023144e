"""Generalized-α family (ode2) + L-BFGS (newton) — accuracy/dissipation."""

import numpy as np
import jax.numpy as jnp
import pytest

from cardiac_ablation_ecm2.linalg import ode2
from cardiac_ablation_ecm2.linalg.newton import lbfgs


class Oscillator:
    """u'' = -ω²u (f.mult / f.implicit_solve protocol)."""

    def __init__(self, omega):
        self.w2 = omega * omega

    def mult(self, t, u, v):
        return -self.w2 * u

    def implicit_solve(self, c0, c1, t, u, v):
        # k = -ω²(u + c0 k)
        return -self.w2 * u / (1.0 + self.w2 * c0)


def _run_galpha(solver, omega, T, nsteps):
    f = Oscillator(omega)
    u = jnp.asarray(1.0)
    v = jnp.asarray(0.0)
    t = 0.0
    a = solver.init(f, u, v, t)
    dt = T / nsteps
    for _ in range(nsteps):
        u, v, a, t = solver.step(f, u, v, a, t, dt)
    return float(u), float(v)


def test_generalized_alpha_second_order():
    omega, T = 2.0, 1.0
    exact = np.cos(omega * T)
    solver = ode2.GeneralizedAlpha2Solver.from_rho(0.8)
    e = []
    for n in (20, 40, 80):
        u, _ = _run_galpha(solver, omega, T, n)
        e.append(abs(u - exact))
    rate = np.log2(e[0] / e[1]), np.log2(e[1] / e[2])
    assert min(rate) > 1.8, (e, rate)


def test_rho1_matches_newmark():
    omega, T, n = 3.0, 0.7, 25
    ga = ode2.GeneralizedAlpha2Solver.from_rho(1.0)
    u_ga, v_ga = _run_galpha(ga, omega, T, n)

    f = Oscillator(omega)
    nm = ode2.NewmarkSolver()
    u = jnp.asarray(1.0)
    v = jnp.asarray(0.0)
    t = 0.0
    for _ in range(n):
        u, v, t = nm.step(f, u, v, t, T / n)
    assert abs(u_ga - float(u)) < 1e-12
    assert abs(v_ga - float(v)) < 1e-12


def test_hht_dissipates_high_frequency():
    """Large ω·dt: dissipative variants decay the amplitude; ρ=1 does not."""
    omega = 100.0
    f = Oscillator(omega)

    def amp(solver, nsteps=200, dt=0.1):
        u = jnp.asarray(1.0)
        v = jnp.asarray(0.0)
        t = 0.0
        a = solver.init(f, u, v, t)
        for _ in range(nsteps):
            u, v, a, t = solver.step(f, u, v, a, t, dt)
        return abs(float(u)) + abs(float(v)) / omega

    a_diss = amp(ode2.GeneralizedAlpha2Solver.from_rho(0.2))
    a_cons = amp(ode2.GeneralizedAlpha2Solver.from_rho(1.0))
    assert a_diss < 1e-3
    assert a_cons > 0.5

    a_hht = amp(ode2.select2("hht", alpha=0.3))
    assert a_hht < a_cons


def test_lbfgs_quadratic():
    """SPD quadratic: L-BFGS must hit the solution fast."""
    rng = np.random.default_rng(0)
    A = rng.random((12, 12))
    A = jnp.asarray(A @ A.T + 12 * np.eye(12))
    b = jnp.asarray(rng.random(12))

    def g(u):
        return A @ u - b

    u, info = lbfgs(g, jnp.zeros(12), rel_tol=1e-10, max_iter=100)
    x = np.linalg.solve(np.asarray(A), np.asarray(b))
    assert bool(info.converged)
    assert np.abs(np.asarray(u) - x).max() < 1e-6


def test_lbfgs_rosenbrock():
    def f(u):
        x, y = u[0], u[1]
        return (1 - x) ** 2 + 100 * (y - x * x) ** 2

    def g(u):
        x, y = u[0], u[1]
        return jnp.stack([
            -2 * (1 - x) - 400 * x * (y - x * x),
            200 * (y - x * x),
        ])

    u, info = lbfgs(g, jnp.asarray([-1.2, 1.0]), rel_tol=1e-9,
                    max_iter=400, energy=f)
    assert np.abs(np.asarray(u) - 1.0).max() < 1e-4, (u, info)


def test_symplectic_energy_conservation():
    """Harmonic oscillator: SIA conserves energy over long horizons where
    explicit Euler blows up; order 2 and 4 converge at their rates."""
    from cardiac_ablation_ecm2.linalg.ode2 import SIASolver

    class Osc:
        def velocity(self, t, p):
            return p

        def force(self, t, q):
            return -q

    f = Osc()

    def run(order, nsteps, T=20.0):
        s = SIASolver(order)
        q, p, t = jnp.asarray(1.0), jnp.asarray(0.0), 0.0
        for _ in range(nsteps):
            q, p, t = s.step(f, q, p, t, T / nsteps)
        return float(q), float(p)

    # long-horizon energy drift stays bounded (symplectic property)
    q, p = run(2, 2000)
    E = 0.5 * (q * q + p * p)
    assert abs(E - 0.5) < 1e-4

    # order-4 beats order-2 at equal step count
    exact_q = np.cos(20.0)
    e2 = abs(run(2, 400)[0] - exact_q)
    e4 = abs(run(4, 400)[0] - exact_q)
    assert e4 < e2 / 50
