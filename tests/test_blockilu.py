"""BlockILU(0) with level-scheduled batched triangular solves
(linalg/solvers.hpp:1068 analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.linalg.blockilu import block_ilu0
from cardiac_ablation_ecm2.linalg.solvers import cg


def _block_coo(dense, nblk, b):
    rows, cols, blocks = [], [], []
    for i in range(nblk):
        for j in range(nblk):
            blk = dense[i * b:(i + 1) * b, j * b:(j + 1) * b]
            if np.any(blk != 0):
                rows.append(i)
                cols.append(j)
                blocks.append(blk)
    return np.stack(blocks), np.array(rows), np.array(cols)


def _tridiag_spd(nblk, b, seed=0):
    rng = np.random.default_rng(seed)
    n = nblk * b
    A = np.zeros((n, n))
    for i in range(nblk):
        d = rng.standard_normal((b, b))
        A[i * b:(i + 1) * b, i * b:(i + 1) * b] = d @ d.T + (4 + b) * np.eye(b)
        if i + 1 < nblk:
            o = 0.5 * rng.standard_normal((b, b))
            A[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = o
            A[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = o.T
    return A


def test_tridiagonal_is_exact():
    """Block-tridiagonal sparsity has no ILU(0) fill — the preconditioner
    is the exact inverse."""
    nblk, b = 12, 4
    A = _tridiag_spd(nblk, b)
    blocks, rows, cols = _block_coo(A, nblk, b)
    M = block_ilu0(blocks, rows, cols, nblk)
    rng = np.random.default_rng(1)
    r = rng.standard_normal(nblk * b)
    x = np.asarray(M.apply(jnp.asarray(r)))
    x_ref = np.linalg.solve(A, r)
    assert np.allclose(x, x_ref, atol=1e-9), np.abs(x - x_ref).max()


def test_grid_graph_accelerates_cg():
    """2D grid block coupling (fill dropped → inexact): BlockILU-PCG needs
    far fewer iterations than Jacobi-PCG."""
    nx = ny = 5
    nblk, b = nx * ny, 3
    rng = np.random.default_rng(2)
    n = nblk * b
    A = np.zeros((n, n))

    def bid(i, j):
        return i * ny + j

    for i in range(nx):
        for j in range(ny):
            k = bid(i, j)
            d = rng.standard_normal((b, b))
            A[k * b:(k + 1) * b, k * b:(k + 1) * b] = \
                d @ d.T + 8 * np.eye(b)
            for (i2, j2) in ((i + 1, j), (i, j + 1)):
                if i2 < nx and j2 < ny:
                    k2 = bid(i2, j2)
                    o = 0.6 * rng.standard_normal((b, b))
                    A[k * b:(k + 1) * b, k2 * b:(k2 + 1) * b] = o
                    A[k2 * b:(k2 + 1) * b, k * b:(k + 1) * b] = o.T
    blocks, rows, cols = _block_coo(A, nblk, b)
    M = block_ilu0(blocks, rows, cols, nblk)
    Aj = jnp.asarray(A)
    rhs = jnp.asarray(rng.standard_normal(n))
    mult = lambda v: Aj @ v
    d = jnp.asarray(np.diag(A))
    _, info_j = cg(mult, rhs, M=lambda r: r / d, rel_tol=1e-10,
                   max_iter=500)
    _, info_b = cg(mult, rhs, M=M.apply, rel_tol=1e-10, max_iter=500)
    assert bool(info_b.converged)
    assert info_b.iterations < 0.55 * info_j.iterations, \
        (info_b.iterations, info_j.iterations)


def test_level_parallelism():
    """A 1D chain of nblk blocks has nblk-1 lower levels; a star graph has
    one — the schedule exposes the graph's wavefronts."""
    nblk, b = 6, 2
    A = _tridiag_spd(nblk, b)
    blocks, rows, cols = _block_coo(A, nblk, b)
    M = block_ilu0(blocks, rows, cols, nblk)
    assert len(M.low) == nblk - 1

    # star with the hub ordered LAST: leaves eliminate first (fill-free,
    # so ILU(0) is exact) and all lower entries target one row → 1 level
    rng = np.random.default_rng(3)
    n = nblk * b
    hub = nblk - 1
    S = np.zeros((n, n))
    for i in range(nblk):
        d = rng.standard_normal((b, b))
        S[i * b:(i + 1) * b, i * b:(i + 1) * b] = d @ d.T + 6 * np.eye(b)
    for i in range(hub):
        o = 0.3 * rng.standard_normal((b, b))
        S[hub * b:(hub + 1) * b, i * b:(i + 1) * b] = o
        S[i * b:(i + 1) * b, hub * b:(hub + 1) * b] = o.T
    blocks, rows, cols = _block_coo(S, nblk, b)
    Ms = block_ilu0(blocks, rows, cols, nblk)
    assert len(Ms.low) == 1
    r = rng.standard_normal(n)
    assert np.allclose(np.asarray(Ms.apply(jnp.asarray(r))),
                       np.linalg.solve(S, r), atol=1e-9)
