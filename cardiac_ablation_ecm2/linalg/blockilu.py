"""Block ILU(0) preconditioner with level-scheduled triangular solves.

Reference analog: ``BlockILU`` (``linalg/solvers.hpp:1068``, impl
``linalg/solvers.cpp``) — incomplete block LU factorization on the
element-block sparsity of a DG operator, the reference's standard DG
preconditioner.

Design: the factorization (small dense blocks, sequential
dependency) is host-side numpy at setup — exactly the reference split.
The *apply* runs on device: rows are grouped into dependency *levels*
(wavefronts of the lower/upper triangular graphs), so each level is one
batched (nblk_level, b, b) matmul + segment-sum; the sequential depth is
the graph's level count (≈ mesh diameter), not the block count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t, real_t


def _levels(n: int, adj_rows: List[List[int]]) -> np.ndarray:
    """Level of each node in the DAG row i ← deps adj_rows[i] (< i)."""
    lev = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if adj_rows[i]:
            lev[i] = 1 + max(lev[j] for j in adj_rows[i])
    return lev


@dataclasses.dataclass(eq=False)
class BlockILU:
    """Factored state + device apply tables."""

    nblk: int
    b: int
    Dinv: jnp.ndarray            # (nblk, b, b) inverted pivots
    # lower solve: per level, (rows, cols, Lblocks)
    low: Tuple
    up: Tuple
    perm: np.ndarray             # block ordering used (identity for now)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        """M⁻¹ r via level-scheduled forward/backward block solves."""
        x = r.reshape(self.nblk, self.b)
        y = x
        for rows, cols, L in self.low:
            upd = jnp.einsum("kij,kj->ki", L, y[cols])
            y = y.at[rows].add(-upd)
        z = jnp.einsum("kij,kj->ki", self.Dinv, y)
        for rows, cols, U in self.up:
            upd = jnp.einsum("kij,kj->ki", self.Dinv[rows],
                             jnp.einsum("kij,kj->ki", U, z[cols]))
            z = z.at[rows].add(-upd)
        return z.reshape(-1)


def block_ilu0(A_blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray,
               nblk: int, dtype=None) -> BlockILU:
    """Factor a block-sparse matrix given in COO block form.

    ``A_blocks`` (nnz, b, b) with block coordinates (rows, cols); must
    include every diagonal block.  Standard ILU(0): for k < i with (i,k)
    present, L_ik = A_ik D_k⁻¹ and A_ij ← A_ij − L_ik A_kj for stored
    (i, j) with j > k."""
    rt = real_t(dtype)
    b = A_blocks.shape[1]
    store = {}
    for blk, i, j in zip(A_blocks, rows, cols):
        store[(int(i), int(j))] = np.array(blk, dtype=np.float64)
    row_cols: List[List[int]] = [[] for _ in range(nblk)]
    for (i, j) in store:
        row_cols[i].append(j)
    for i in range(nblk):
        row_cols[i].sort()
        assert (i, i) in store, f"missing diagonal block {i}"

    L = {}
    for i in range(nblk):
        for k in row_cols[i]:
            if k >= i:
                break
            Dk_inv = np.linalg.inv(store[(k, k)])
            Lik = store[(i, k)] @ Dk_inv
            L[(i, k)] = Lik
            for j in row_cols[k]:
                if j > k and (i, j) in store:
                    store[(i, j)] = store[(i, j)] - Lik @ store[(k, j)]

    Dinv = np.stack([np.linalg.inv(store[(i, i)]) for i in range(nblk)])

    def schedule(entries, lower: bool):
        """entries: dict (i, j)→block with j<i (lower) or j>i (upper).
        Group by dependency level of the TARGET row."""
        deps: List[List[int]] = [[] for _ in range(nblk)]
        for (i, j) in entries:
            deps[i].append(j)
        order = range(nblk) if lower else range(nblk - 1, -1, -1)
        lev = np.zeros(nblk, dtype=np.int64)
        for i in order:
            ds = [j for j in deps[i]]
            if ds:
                lev[i] = 1 + max(lev[j] for j in ds)
        out = []
        nlev = int(lev.max()) + 1 if len(entries) else 0
        for l in range(1, nlev):
            rs, cs, blks = [], [], []
            for (i, j), blk in entries.items():
                if lev[i] == l:
                    rs.append(i)
                    cs.append(j)
                    blks.append(blk)
            if rs:
                out.append((jnp.asarray(rs, index_t()),
                            jnp.asarray(cs, index_t()),
                            jnp.asarray(np.stack(blks), rt)))
        return tuple(out)

    low_entries = {(i, j): blk for (i, j), blk in L.items()}
    up_entries = {(i, j): store[(i, j)] for (i, j) in store if j > i}
    return BlockILU(
        nblk=nblk, b=b, Dinv=jnp.asarray(Dinv, rt),
        low=schedule(low_entries, True),
        up=schedule(up_entries, False),
        perm=np.arange(nblk),
    )
