"""ODE solver convergence orders (reference analog:
tests/unit/linalg/test_ode.cpp, which checks the convergence order of every
ODE solver on a linear system)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.linalg import ode


A = np.array([[0.0, 1.0], [-4.0, -0.1]])
U0 = np.array([1.0, 0.5])


def forcing(t):
    return np.array([0.2 * np.sin(t), 0.1 * np.cos(2 * t)])


class LinearOp:
    """du/dt = A u + s(t) with exact implicit stage solve."""

    def mult(self, t, u):
        return jnp.asarray(A) @ u + jnp.asarray(forcing(t))

    def implicit_solve(self, gamma, t, u):
        # k = A(u + γk) + s(t)  ⇒  (I − γA) k = A u + s(t)
        M = np.eye(2) - gamma * A
        rhs = jnp.asarray(A) @ u + jnp.asarray(forcing(t))
        return jnp.asarray(np.linalg.inv(M)) @ rhs


def reference_solution(T, n=20000):
    """RK4 with tiny steps as the reference."""
    f = LinearOp()
    solver = ode.select("rk4")
    u, t = jnp.asarray(U0), 0.0
    dt = T / n
    for _ in range(n):
        u, t = solver.step(f, u, t, dt)
    return np.asarray(u)


REF = {}


def run(solver_name, T, n):
    f = LinearOp()
    solver = ode.select(solver_name)
    u, t = jnp.asarray(U0), 0.0
    dt = T / n
    for _ in range(n):
        u, t = solver.step(f, u, t, dt)
    return np.asarray(u)


@pytest.mark.parametrize(
    "name,order",
    [
        ("forward_euler", 1),
        ("rk2", 2),
        ("rk3_ssp", 3),
        ("rk4", 4),
        ("backward_euler", 1),
        ("implicit_midpoint", 2),
        ("sdirk23", 3),
        ("sdirk33", 3),
        ("sdirk34", 4),
        ("trapezoidal", 2),
        ("esdirk32", 2),
        ("esdirk33", 3),
    ],
)
def test_convergence_order(name, order):
    T = 1.0
    if "ref" not in REF:
        REF["ref"] = reference_solution(T)
    ref = REF["ref"]
    n1, n2 = 32, 64
    e1 = np.linalg.norm(run(name, T, n1) - ref)
    e2 = np.linalg.norm(run(name, T, n2) - ref)
    est = np.log2(e1 / e2)
    assert est > order - 0.35, (name, e1, e2, est)


def test_numeric_id_registry():
    assert ode.select(23).tableau.name == "sdirk33"
    assert ode.select(4).tableau.name == "rk4"
    assert ode.select(21).tableau.name == "backward_euler"


def test_imex_euler_matches_split():
    """IMEX on a split where both parts are the same linear op ≈ stable."""

    class SplitOp(LinearOp):
        def mult_explicit(self, t, u):
            return jnp.asarray(forcing(t))

        def implicit_solve(self, gamma, t, u):
            M = np.eye(2) - gamma * A
            return jnp.asarray(np.linalg.inv(M)) @ (jnp.asarray(A) @ u)

    T, n = 1.0, 200
    f = SplitOp()
    for name, tol in [("imex_euler", 2e-2), ("imex_rk2", 2e-3)]:
        solver = ode.select(name)
        u, t = jnp.asarray(U0), 0.0
        for _ in range(n):
            u, t = solver.step(f, u, t, T / n)
        ref = REF.get("ref")
        if ref is None:
            ref = REF["ref"] = reference_solution(T)
        assert np.linalg.norm(np.asarray(u) - ref) < tol, name


@pytest.mark.parametrize("name,order", [("ab2", 2), ("ab4", 4), ("am2", 3), ("am3", 4)])
def test_multistep_convergence(name, order):
    """Adams-Bashforth / Adams-Moulton (PECE) orders (AB_k: k, AM_k PECE:
    k+1)."""
    T = 1.0
    if "ref" not in REF:
        REF["ref"] = reference_solution(T)
    ref = REF["ref"]

    def run_ms(n):
        f = LinearOp()
        solver = ode.select(name)      # fresh instance (history state)
        u, t = jnp.asarray(U0), 0.0
        for _ in range(n):
            u, t = solver.step(f, u, t, T / n)
        return np.asarray(u)

    e1 = np.linalg.norm(run_ms(64) - ref)
    e2 = np.linalg.norm(run_ms(128) - ref)
    est = np.log2(e1 / e2)
    assert est > order - 0.4, (name, e1, e2, est)
