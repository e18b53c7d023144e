"""Newton's method with matrix-free Jacobians.

Reference analog: ``NewtonSolver`` (``linalg/solvers.hpp:780``) driving
``Operator::GetGradient`` — where the reference hand-codes per-integrator
gradient assembly (``NonlinearForm::GetGradient``), this package gets the
exact Jacobian action for free via ``jax.linearize`` on the residual.  This
replaces the entire AD subsystem of the reference (dFEM/Enzyme/dual numbers,
SURVEY.md §2.4) — JAX *is* the AD framework.

Inner linear solves are CG (SPD Jacobians) or GMRES, inexact-Newton style
with a fixed inner tolerance; globalization is a simple backtracking line
search on ‖F‖ (the reference's default Newton has none; ``SetAdaptiveLinRtol``
-style forcing terms can be layered later).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .solvers import cg, default_dot, gmres


class NewtonInfo(NamedTuple):
    iterations: jnp.ndarray
    final_norm: jnp.ndarray
    converged: jnp.ndarray


def newton(
    residual: Callable,
    u0: jnp.ndarray,
    rel_tol: float = 1e-10,
    abs_tol: float = 0.0,
    max_iter: int = 20,
    linear_solver: str = "cg",
    linear_rel_tol: float = 1e-8,
    linear_max_iter: int = 500,
    precond: Optional[Callable] = None,   # (u) -> M callable, rebuilt per step
    line_search: int = 0,                  # max halvings (0 = full steps)
    dot: Callable = default_dot,
):
    """Solve residual(u) = 0.  Jit-safe (fixed trace bounds everywhere)."""

    def norm(v):
        return jnp.sqrt(dot(v, v))

    F0 = residual(u0)
    n0 = norm(F0)
    target = jnp.maximum(rel_tol * n0, abs_tol)

    def cond(state):
        u, F, nF, k, done = state
        return jnp.logical_and(k < max_iter, jnp.logical_not(done))

    def body(state):
        u, F, nF, k, _ = state
        _, jvp = jax.linearize(residual, u)
        M = precond(u) if precond is not None else None
        if linear_solver == "cg":
            du, _info = cg(jvp, -F, M=M, rel_tol=linear_rel_tol,
                           max_iter=linear_max_iter, dot=dot)
        else:
            du, _info = gmres(jvp, -F, M=M, rel_tol=linear_rel_tol,
                              max_iter=linear_max_iter, dot=dot)

        if line_search > 0:
            def ls_body(i, carry):
                alpha, best_u, best_n = carry
                u_try = u + alpha * du
                n_try = norm(residual(u_try))
                better = n_try < best_n
                return (
                    alpha * 0.5,
                    jnp.where(better, u_try, best_u),
                    jnp.where(better, n_try, best_n),
                )

            _, u_new, n_new = lax.fori_loop(
                0, line_search + 1, ls_body, (jnp.ones_like(nF), u, nF)
            )
        else:
            u_new = u + du
            n_new = norm(residual(u_new))
        F_new = residual(u_new)
        done = n_new <= target
        return (u_new, F_new, n_new, k + 1, done)

    u, F, nF, k, done = lax.while_loop(
        cond, body, (u0, F0, n0, jnp.int32(0), n0 <= target)
    )
    return u, NewtonInfo(iterations=k, final_norm=nF, converged=done)


def lbfgs(
    grad: Callable,
    u0: jnp.ndarray,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 200,
    history: int = 10,
    line_search: int = 24,
    dot: Callable = default_dot,
    energy: Optional[Callable] = None,
):
    """L-BFGS for grad(u) = 0.

    Reference analog: ``LBFGSSolver`` (``linalg/solvers.hpp:874``) — quasi-
    Newton with a fixed-size (s, y) ring buffer and the two-loop recursion.
    Jit-safe: fixed trace bounds, ring buffers as stacked arrays, history
    masking via ρ=0 for unfilled slots.

    Line search: Armijo on ``energy`` when given (the robust choice for
    minimization, e.g. hyperelastic stored energy); otherwise backtracking
    on ‖grad‖ decrease (root-finding mode).
    """
    m = history
    n = u0.shape[0]

    def norm(v):
        return jnp.sqrt(dot(v, v))

    g0 = grad(u0)
    n0 = norm(g0)
    target = jnp.maximum(rel_tol * n0, abs_tol)
    S = jnp.zeros((m, n), u0.dtype)
    Y = jnp.zeros((m, n), u0.dtype)
    R = jnp.zeros((m,), u0.dtype)          # 1/(yᵀs); 0 marks an empty slot

    def two_loop(g, S, Y, R, head, gamma):
        # iterate newest → oldest; slot index (head-1-i) mod m
        def bwd(i, carry):
            q, alphas = carry
            j = (head - 1 - i) % m
            a = R[j] * dot(S[j], q)
            a = jnp.where(R[j] != 0, a, 0.0)
            return q - a * Y[j], alphas.at[j].set(a)

        q, alphas = lax.fori_loop(0, m, bwd, (g, jnp.zeros((m,), g.dtype)))
        r = gamma * q

        def fwd(i, r):
            j = (head + i) % m
            b = R[j] * dot(Y[j], r)
            b = jnp.where(R[j] != 0, b, 0.0)
            return r + (alphas[j] - b) * S[j]

        return lax.fori_loop(0, m, fwd, r)

    def cond(st):
        u, g, ng, S, Y, R, head, gamma, k, done = st
        return jnp.logical_and(k < max_iter, jnp.logical_not(done))

    def body(st):
        u, g, ng, S, Y, R, head, gamma, k, _ = st
        d = -two_loop(g, S, Y, R, head, gamma)
        if energy is not None:
            f_u = energy(u)
            slope = dot(g, d)             # < 0 for a descent direction
        # backtracking: Armijo on energy when available, else ‖grad‖ decrease
        def ls(i, carry):
            alpha, bu, bg, bn, found = carry
            u_try = u + alpha * d
            g_try = grad(u_try)
            n_try = norm(g_try)
            if energy is not None:
                ok = energy(u_try) <= f_u + 1e-4 * alpha * slope
            else:
                ok = n_try < ng
            take = jnp.logical_and(jnp.logical_not(found), ok)
            return (
                alpha * 0.5,
                jnp.where(take, u_try, bu),
                jnp.where(take, g_try, bg),
                jnp.where(take, n_try, bn),
                jnp.logical_or(found, take),
            )

        # start above 1 so steps can *grow* — backtracking capped at α=1
        # crawls on curved valleys (Rosenbrock) when the history is degenerate
        _, u1, g1, n1, found = lax.fori_loop(
            0, line_search,
            ls, (jnp.asarray(4.0, u.dtype), u, g, ng, False)
        )
        # steepest-descent fallback step if the line search found nothing
        tiny = jnp.asarray(1e-4, u.dtype) / jnp.maximum(ng, 1e-30)
        u1 = jnp.where(found, u1, u - tiny * g)
        g1 = jnp.where(found, g1, grad(u - tiny * g))
        n1 = jnp.where(found, n1, norm(g1))
        s, y = u1 - u, g1 - g
        ys = dot(y, s)
        ok = ys > 1e-30
        S1 = jnp.where(ok, S.at[head].set(s), S)
        Y1 = jnp.where(ok, Y.at[head].set(y), Y)
        R1 = jnp.where(ok, R.at[head].set(1.0 / jnp.where(ok, ys, 1.0)), R)
        head1 = jnp.where(ok, (head + 1) % m, head)
        gamma1 = jnp.where(ok, ys / jnp.maximum(dot(y, y), 1e-30), gamma)
        done = n1 <= target
        return (u1, g1, n1, S1, Y1, R1, head1, gamma1, k + 1, done)

    st = (u0, g0, n0, S, Y, R, jnp.int32(0), jnp.ones((), u0.dtype),
          jnp.int32(0), n0 <= target)
    u, g, ng, *_rest = lax.while_loop(cond, body, st)
    k, done = _rest[-2], _rest[-1]
    return u, NewtonInfo(iterations=k, final_norm=ng, converged=done)
