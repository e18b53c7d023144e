"""LOBPCG generalized eigensolver.

Reference analog: ``HypreLOBPCG`` (``linalg/hypre.hpp:2149``), used by ex11
(Laplace eigenmodes) / ex12 (elasticity) / ex13.

Matrix-free locally-optimal block PCG for the smallest eigenpairs of
A x = λ M x.  Block Rayleigh-Ritz in the [X, W, P] subspace with M-orthonormal
basis via Cholesky; all dense work is (3k × 3k) ``jnp.linalg`` — tiny, fine on
device or host.  Static iteration count (jit-safe).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class EigResult(NamedTuple):
    eigenvalues: jnp.ndarray    # (k,)
    eigenvectors: jnp.ndarray   # (n, k), M-orthonormal
    residuals: jnp.ndarray      # (k,) final ‖A x − λ M x‖


def _m_orthonormalize(V, Mmult):
    MV = _apply_cols(Mmult, V)
    G = V.T @ MV
    # Cholesky with jitter for safety
    L = jnp.linalg.cholesky(G + 1e-14 * jnp.eye(G.shape[0], dtype=G.dtype))
    Vo = jax.scipy.linalg.solve_triangular(L, V.T, lower=True).T
    return Vo


def _apply_cols(op: Callable, V: jnp.ndarray) -> jnp.ndarray:
    return jax.vmap(op, in_axes=1, out_axes=1)(V)


def lobpcg(
    A: Callable,
    M: Optional[Callable],
    n: int,
    k: int,
    precond: Optional[Callable] = None,
    iters: int = 50,
    seed: int = 0,
    dtype=jnp.float64,
    X0: Optional[jnp.ndarray] = None,
    constraint: Optional[Callable] = None,
) -> EigResult:
    """Smallest k eigenpairs of A x = λ M x (M=None ⇒ identity).

    ``constraint``: projector onto the admissible subspace (e.g. zero at
    essential dofs — HypreLOBPCG::SetSubSpaceProjector analog); applied to
    the initial block and every expansion direction so constrained modes
    never enter the Rayleigh-Ritz space."""
    Mmult = M if M is not None else (lambda v: v)
    prec = precond if precond is not None else (lambda v: v)
    proj = constraint if constraint is not None else (lambda v: v)

    if X0 is None:
        X = jax.random.normal(jax.random.PRNGKey(seed), (n, k), dtype=dtype)
    else:
        X = X0.astype(dtype)
    X = _apply_cols(proj, X)
    X = _m_orthonormalize(X, Mmult)
    P = jnp.zeros_like(X)

    BIG = jnp.asarray(1e30, dtype)

    def rayleigh_ritz(S):
        # rank-revealing M-orthonormalization: null directions (e.g. the
        # zero P block on the first iteration) are kept with zero weight and
        # pushed to the top of the spectrum instead of corrupting a Cholesky
        MS = _apply_cols(Mmult, S)
        G = S.T @ MS
        G = 0.5 * (G + G.T)
        w, Q = jnp.linalg.eigh(G)
        good = w > 1e-12 * jnp.max(w)
        inv = jnp.where(good, 1.0 / jnp.sqrt(jnp.abs(w) + 1e-300), 0.0)
        Sb = S @ (Q * inv[None, :])
        H = Sb.T @ _apply_cols(A, Sb)
        H = 0.5 * (H + H.T)
        H = H + jnp.diag(jnp.where(good, 0.0, BIG))
        mu, Z = jnp.linalg.eigh(H)
        return Sb @ Z[:, :k], mu[:k]

    def body(i, carry):
        X, P, lam = carry
        AX = _apply_cols(A, X)
        MX = _apply_cols(Mmult, X)
        R = AX - MX * lam[None, :]
        W = _apply_cols(proj, _apply_cols(prec, R))
        S = jnp.concatenate([X, W, P], axis=1)
        Xn, lam_n = rayleigh_ritz(S)
        Pn = Xn - X @ (X.T @ _apply_cols(Mmult, Xn))
        return (Xn, Pn, lam_n)

    lam0 = jnp.ones(k, dtype=dtype)
    X, P, lam = _py_loop(body, (X, P, lam0), iters)

    AX = _apply_cols(A, X)
    MX = _apply_cols(Mmult, X)
    R = AX - MX * lam[None, :]
    res = jnp.sqrt(jnp.sum(R * R, axis=0))
    return EigResult(eigenvalues=lam, eigenvectors=X, residuals=res)


def _py_loop(body, carry, iters):
    # python loop (unrolled under jit); fori_loop also works but the python
    # loop keeps the first iterations' degenerate P handling simple to trace
    for i in range(iters):
        carry = body(i, carry)
    return carry
