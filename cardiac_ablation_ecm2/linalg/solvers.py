"""Matrix-free iterative solvers.

Reference analog: ``linalg/solvers.hpp`` — ``CGSolver`` (impl
``solvers.cpp:869``), ``GMRESSolver``, ``BiCGSTABSolver``, ``MINRESSolver``,
with ``IterativeSolver::Dot`` = (MPI_Allreduce'd) inner product
(``solvers.cpp:58``).

Design:
* Operators and preconditioners are callables ``x -> Ax`` (closures over
  device arrays); the solves are pure jittable functions built on
  ``lax.while_loop`` — fixed shapes, traced iteration counts.
* The inner product is injectable: serial = ``jnp.vdot`` (optionally
  accumulated in float64 for mixed-precision CG — SURVEY.md §7 risk 1);
  sharded = a psum-reducing dot from ``parallel/``.
* Convergence criteria mirror MFEM's: CG stops when (r,z) ≤
  max(rel_tol²·(r0,z0), abs_tol²) — iteration-count parity with the
  reference requires matching this exactly (BASELINE.md).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.config import config


def default_dot(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Inner product, accumulated in f64 when configured and x64 is on.

    Mixed-precision CG: f32 vectors, f64 sums — plain f32 tree sums
    stagnate at ~4e-7 relative error under cancellation, which stalls the
    MFEM-style (r,z) stopping test at tight tolerances.
    """
    if (
        config.f64_reductions
        and jax.config.jax_enable_x64
        and x.dtype != jnp.float64
    ):
        return jnp.vdot(
            x.astype(jnp.float64), y.astype(jnp.float64)
        ).astype(x.dtype)
    return jnp.vdot(x, y)


class SolveInfo(NamedTuple):
    iterations: jnp.ndarray   # int32
    final_norm: jnp.ndarray   # sqrt of final (r,z)
    converged: jnp.ndarray    # bool


def cg(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
    check_convergence: bool = True,
):
    """Preconditioned conjugate gradients (CGSolver::Mult, solvers.cpp:869).

    Returns (x, SolveInfo).  Jit-safe; ``max_iter`` is the trace bound.
    ``check_convergence=False`` runs exactly ``max_iter`` iterations — the
    benchmarking mode (fixed-work BP measurements).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    prec = M if M is not None else (lambda v: v)

    r0 = b - A(x0)
    z0 = prec(r0)
    nom0 = dot(z0, r0)
    target = jnp.maximum(rel_tol * rel_tol * nom0, abs_tol * abs_tol)

    def cond(state):
        x, r, d, nom, k, done = state
        return jnp.logical_and(k < max_iter, jnp.logical_not(done))

    def body(state):
        x, r, d, nom, k, _ = state
        Ad = A(d)
        den = dot(d, Ad)
        alpha = nom / den
        x = x + alpha * d
        r = r - alpha * Ad
        z = prec(r)
        betanom = dot(r, z)
        done = (betanom <= target) if check_convergence else jnp.asarray(False)
        beta = betanom / nom
        d = z + beta * d
        return (x, r, d, betanom, k + 1, done)

    init_done = nom0 <= target
    x, r, d, nom, k, done = lax.while_loop(
        cond, body, (x0, r0, z0, nom0, jnp.int32(0), init_done)
    )
    info = SolveInfo(
        iterations=k,
        final_norm=jnp.sqrt(jnp.abs(nom)),
        converged=nom <= target,
    )
    return x, info


def gmres(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 200,
    restart: int = 50,
    dot: Callable = default_dot,
):
    """Restarted left-preconditioned GMRES (GMRESSolver, solvers.cpp).

    Static-shape Krylov basis of size ``restart``; outer loop via
    ``lax.while_loop``.  Suitable for the nonsymmetric operators
    (convection-dominated) where CG does not apply.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    prec = M if M is not None else (lambda v: v)
    n = b.shape[0]
    m = restart
    dt = b.dtype

    r0 = prec(b - A(x0))
    beta0 = jnp.sqrt(dot(r0, r0))
    target = jnp.maximum(rel_tol * beta0, abs_tol)

    def arnoldi_cycle(x):
        r = prec(b - A(x))
        beta = jnp.sqrt(dot(r, r))
        V = jnp.zeros((m + 1, n), dt).at[0].set(r / jnp.maximum(beta, 1e-300))
        H = jnp.zeros((m + 1, m), dt)
        cs = jnp.zeros(m, dt)
        sn = jnp.zeros(m, dt)
        g = jnp.zeros(m + 1, dt).at[0].set(beta)

        def step(j, carry):
            V, H, cs, sn, g, res, done, cnt = carry
            cnt = cnt + jnp.where(done, 0, 1).astype(jnp.int32)

            def do(carry):
                V, H, cs, sn, g, res = carry
                w = prec(A(V[j]))
                # modified Gram-Schmidt against all basis vectors (masked)
                def mgs(i, wh):
                    w, H = wh
                    hij = jnp.where(i <= j, dot(w, V[i]), 0.0)
                    w = w - hij * V[i]
                    H = H.at[i, j].set(hij)
                    return (w, H)

                w, H = lax.fori_loop(0, m + 1, mgs, (w, H))
                hj1 = jnp.sqrt(dot(w, w))
                H = H.at[j + 1, j].set(hj1)
                V2 = V.at[j + 1].set(w / jnp.maximum(hj1, 1e-300))
                # apply existing Givens rotations to column j
                def giv(i, H):
                    t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                    H = H.at[i + 1, j].set(-sn[i] * H[i, j] + cs[i] * H[i + 1, j])
                    return H.at[i, j].set(t)

                H = lax.fori_loop(0, j, giv, H)
                denom = jnp.sqrt(H[j, j] ** 2 + H[j + 1, j] ** 2)
                c = H[j, j] / jnp.maximum(denom, 1e-300)
                s = H[j + 1, j] / jnp.maximum(denom, 1e-300)
                cs2 = cs.at[j].set(c)
                sn2 = sn.at[j].set(s)
                H = H.at[j, j].set(denom).at[j + 1, j].set(0.0)
                g2 = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])
                res = jnp.abs(g2[j + 1])
                return (V2, H, cs2, sn2, g2, res)

            V, H, cs, sn, g, res = lax.cond(
                done, lambda c: c, do, (V, H, cs, sn, g, res)
            )
            done = jnp.logical_or(done, res <= target)
            return (V, H, cs, sn, g, res, done, cnt)

        V, H, cs, sn, g, res, done, ninner = lax.fori_loop(
            0, m, step,
            (V, H, cs, sn, g, beta, beta <= target, jnp.int32(0)),
        )
        # back-substitution on the m×m triangular system (masked for early exit)
        y = jnp.zeros(m, dt)

        def back(i, y):
            j = m - 1 - i
            num = g[j] - H[j] @ y
            yj = jnp.where(jnp.abs(H[j, j]) > 0, num / jnp.where(H[j, j] == 0, 1.0, H[j, j]), 0.0)
            return y.at[j].set(yj)

        y = lax.fori_loop(0, m, back, y)
        x_new = x + V[:m].T @ y
        return x_new, res, ninner

    def cond(state):
        x, res, it, cyc, done = state
        return jnp.logical_and(
            cyc < (max_iter + m - 1) // m, jnp.logical_not(done)
        )

    def body(state):
        x, res, it, cyc, done = state
        x, res, ninner = arnoldi_cycle(x)
        return (x, res, it + ninner, cyc + 1, res <= target)

    x, res, it, cyc, done = lax.while_loop(
        cond, body, (x0, beta0, jnp.int32(0), jnp.int32(0), beta0 <= target)
    )
    # ``iterations`` counts actual Arnoldi steps taken (MFEM-parity
    # accounting), not cycles × restart.
    info = SolveInfo(iterations=it, final_norm=res, converged=done)
    return x, info


def power_method(
    A: Callable, n: int = None, iters: int = 30, seed: int = 7, dtype=None,
    dot=default_dot, v0: Optional[jnp.ndarray] = None,
):
    """Largest-eigenvalue estimate by power iteration (used by Chebyshev —
    reference: OperatorChebyshevSmoother's PowerMethod, linalg/solvers.cpp).

    Pass ``v0`` for a deterministic start (required under shard_map, where
    the start must be halo-consistent across devices)."""
    if v0 is not None:
        v = v0
    else:
        key = jax.random.PRNGKey(seed)
        v = jax.random.uniform(key, (n,), dtype=dtype or jnp.float32)

    def step(_, carry):
        v, lam = carry
        w = A(v)
        lam = jnp.sqrt(dot(w, w))
        return (w / jnp.maximum(lam, 1e-300), lam)

    v, lam = lax.fori_loop(0, iters, step, (v, jnp.array(1.0, v.dtype)))
    w = A(v)
    return dot(v, w) / dot(v, v)


def cg_merged(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    rel_tol: float = 1e-8,
    abs_tol: float = 0.0,
    max_iter: int = 500,
    dot: Callable = default_dot,
    check_convergence: bool = True,
):
    """Single-reduction (Chronopoulos–Gear) preconditioned CG.

    Mathematically the same iterates as ``cg`` but restructured so each
    iteration has ONE synchronization region: both inner products
    ((r,u) and (w,u)) are evaluated back-to-back after the operator
    apply, and every vector update uses lagged scalars.  This halves the
    number of serialized reduction→scalar→elementwise chains inside the
    ``lax.while_loop`` body.  Reference hot loop: ``CGSolver::Mult``
    (linalg/solvers.cpp:869); restructuring per Chronopoulos & Gear,
    J. Comput. Appl. Math. 25 (1989).

    Same stopping rule as ``cg``: (r, M r) ≤ max(rel_tol²·(r₀, M r₀),
    abs_tol²).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    prec = M if M is not None else (lambda v: v)

    r0 = b - A(x0)
    u0 = prec(r0)
    w0 = A(u0)
    gamma0 = dot(r0, u0)
    delta0 = dot(w0, u0)
    target = jnp.maximum(rel_tol * rel_tol * gamma0, abs_tol * abs_tol)
    safe = lambda x: jnp.where(x == 0, 1.0, x)
    alpha0 = gamma0 / safe(delta0)

    def cond(st):
        return jnp.logical_and(st[-2] < max_iter, jnp.logical_not(st[-1]))

    def body(st):
        x, r, u, w, p, s, alpha, beta, gamma, k, _ = st
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = prec(r)
        w = A(u)
        gamma_new = dot(r, u)
        delta = dot(w, u)
        beta_new = gamma_new / safe(gamma)
        alpha_new = gamma_new / safe(delta - beta_new * gamma_new /
                                     safe(alpha))
        done = (gamma_new <= target) if check_convergence \
            else jnp.asarray(False)
        return (x, r, u, w, p, s, alpha_new, beta_new, gamma_new,
                k + 1, done)

    z = jnp.zeros_like(b)
    init = (x0, r0, u0, w0, z, z, alpha0, jnp.zeros((), b.dtype),
            gamma0, jnp.int32(0), gamma0 <= target)
    st = lax.while_loop(cond, body, init)
    x, gamma, k, done = st[0], st[8], st[9], st[10]
    info = SolveInfo(
        iterations=k,
        final_norm=jnp.sqrt(jnp.abs(gamma)),
        converged=gamma <= target,
    )
    return x, info
