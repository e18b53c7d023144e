"""Small constrained-optimization solvers: SLBQP and NNLS.

Reference analogs: ``SLBQPOptimizer`` (``linalg/solvers.hpp:1306``,
``linalg/solvers.cpp`` Solve) — the single-linear-constraint bound QP used
by conservative field transfer/limiting — and the ``NNLS`` active-set
solver (``linalg/nnls.hpp:27``) used for quadrature sparsification in
hyper-reduction.

Notes: SLBQP's inner evaluation (clip + two reductions) is a
perfect XLA fusion and runs entirely on device under ``jit``; the scalar
secant/bisection iteration is a ``lax.while_loop``.  NNLS is a host-side
active-set method (tiny dense problems by construction) in numpy.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def slbqp(
    w: jnp.ndarray,
    lo,
    hi,
    a: float,
    weights: jnp.ndarray = None,
    tol: float = 1e-12,
    max_iter: int = 200,
) -> Tuple[jnp.ndarray, int]:
    """minimize ½‖x − w‖² s.t. lo ≤ x ≤ hi and Σ cᵢ xᵢ = a.

    Solution is x(λ) = clip(w + λ c, lo, hi) with the multiplier λ chosen
    so the constraint holds; r(λ) = Σ c·x(λ) − a is monotone in λ, solved
    by bracketing bisection + secant (SLBQPOptimizer::Solve analog).
    Returns (x, iterations)."""
    c = jnp.ones_like(w) if weights is None else jnp.asarray(weights,
                                                             w.dtype)
    lo = jnp.broadcast_to(jnp.asarray(lo, w.dtype), w.shape)
    hi = jnp.broadcast_to(jnp.asarray(hi, w.dtype), w.shape)

    def r(lam):
        return jnp.sum(c * jnp.clip(w + lam * c, lo, hi)) - a

    # initial bracket: expand geometrically until r changes sign
    scale = jnp.maximum(jnp.max(hi - lo), 1.0)

    def grow(state):
        l, u, k = state
        return l * 2, u * 2, k + 1

    def need(state):
        l, u, k = state
        return ((r(l) > 0) | (r(u) < 0)) & (k < 60)

    l0, u0, _ = lax.while_loop(need, grow, (-scale, scale, 0))

    def body(state):
        l, u, k = state
        m = 0.5 * (l + u)
        rm = r(m)
        l = jnp.where(rm < 0, m, l)
        u = jnp.where(rm >= 0, m, u)
        return l, u, k + 1

    def cond(state):
        l, u, k = state
        return (jnp.abs(r(0.5 * (l + u))) > tol) & (k < max_iter)

    l, u, iters = lax.while_loop(cond, body, (l0, u0, 0))
    lam = 0.5 * (l + u)
    return jnp.clip(w + lam * c, lo, hi), int(iters)


def nnls(A: np.ndarray, b: np.ndarray, tol: float = None,
         max_iter: int = None) -> np.ndarray:
    """Lawson–Hanson active-set NNLS: min ‖Ax − b‖₂ s.t. x ≥ 0
    (linalg/nnls.hpp:27 analog; host-side numpy — the problems are small
    dense systems from quadrature sparsification)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n = A.shape
    if tol is None:
        tol = 10 * np.finfo(np.float64).eps * np.linalg.norm(A, 1) * max(
            m, n)
    if max_iter is None:
        max_iter = 3 * n
    P = np.zeros(n, dtype=bool)
    x = np.zeros(n)
    resid = b - A @ x
    w = A.T @ resid
    it = 0
    while (~P).any() and np.max(np.where(P, -np.inf, w)) > tol \
            and it < max_iter:
        j = int(np.argmax(np.where(P, -np.inf, w)))
        P[j] = True
        while True:
            it += 1
            idx = np.nonzero(P)[0]
            s = np.zeros(n)
            s[idx], *_ = np.linalg.lstsq(A[:, idx], b, rcond=None)
            if np.all(s[idx] > 0):
                x = s
                break
            neg = idx[s[idx] <= 0]
            alpha = np.min(x[neg] / (x[neg] - s[neg]))
            x = x + alpha * (s - x)
            P &= x > tol
            x[~P] = 0.0
            if it >= max_iter:
                break
        resid = b - A @ x
        w = A.T @ resid
    return x
