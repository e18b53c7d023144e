"""ELL-format SpMV — the assembled-operator apply.

At order 1 on simplex meshes every dof is a vertex dof with multiplicity up
to ~25 (tets), so the matrix-free L→E→Q→E→L pipeline is scatter-bound.  But
a p1 operator is also a TINY sparse matrix (nnz/row ≈ 15 — the reference
runs its own LEGACY/FULL CSR path at p1, ``fem/bilinearform.cpp``), and an
SpMV in ELL form

    y[i] = Σ_j vals[j, i] · x[cols[j, i]]          (j < J = max nnz/row)

has NO scatter at all: it is J fixed gathers + a weighted sum, which XLA
fuses into one gather-multiply-reduce.  Padding slots point at column n
(one trailing zero appended to x) with weight 0.

Reference analog: ``SparseMatrix::Mult`` device path
(``linalg/sparsemat.cpp``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t
from .operators import LinearOperator


def _ell_apply(x, cols, vals):
    """Σ_j vals[j] · x̃[cols[j]] with x̃ = [x, 0] (column n reads zero)."""
    xp = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
    return jnp.sum(vals.astype(x.dtype) * xp[cols], axis=0)


def _ell_slab(indptr, indices, datas, rows, J, ncols):
    """(cols (J, nb), [vals (J, nb) per data]) for the given CSR rows, padded
    to J slots per row; padding reads column ``ncols`` with weight 0."""
    nb = len(rows)
    cols = np.full((J, nb), ncols, dtype=np.int64)
    valss = [np.zeros((J, nb), dtype=np.float64) for _ in datas]
    nnzr = indptr[rows + 1] - indptr[rows]
    tot = int(nnzr.sum())
    rep = np.repeat(np.arange(nb), nnzr)
    slot = np.arange(tot) - np.repeat(np.cumsum(nnzr) - nnzr, nnzr)
    pos = np.repeat(indptr[rows], nnzr) + slot
    cols[slot, rep] = indices[pos]
    for vals, data in zip(valss, datas):
        vals[slot, rep] = data[pos]
    return cols, valss


@dataclasses.dataclass(frozen=True)
class ELLOperator:
    """Sparse operator in one global-width ELL slab.

    Registered as a pytree so it can ride as a jit ARGUMENT (closed-over
    device arrays become compile-time constants — hostile at scale)."""

    cols: jnp.ndarray         # (J, n) int32, n_cols == "reads zero"
    vals: jnp.ndarray         # (J, n)
    diag: jnp.ndarray         # (n,)
    ncols: int

    @property
    def shape(self):
        return (self.cols.shape[1], self.ncols)

    @staticmethod
    def from_csr(A, dtype="float32") -> "ELLOperator":
        """Build from a scipy CSR/CSC/COO matrix (host, setup time)."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n, m = A.shape
        J = int(np.diff(A.indptr).max()) if n else 0
        cols, (vals,) = _ell_slab(A.indptr, A.indices, [A.data],
                                  np.arange(n), J, m)
        return ELLOperator(
            cols=jnp.asarray(cols, index_t()),
            vals=jnp.asarray(vals.astype(np.dtype(dtype))),
            diag=jnp.asarray(A.diagonal().astype(np.dtype(dtype))),
            ncols=int(m),
        )

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        return _ell_apply(x, self.cols, self.vals)

    def diagonal(self) -> jnp.ndarray:
        return self.diag

    def operator(self) -> LinearOperator:
        return LinearOperator(shape=self.shape, mult=self.mult,
                              diagonal_fn=self.diagonal)


jax.tree_util.register_pytree_node(
    ELLOperator,
    lambda t: ((t.cols, t.vals, t.diag), (t.ncols,)),
    lambda aux, ch: ELLOperator(cols=ch[0], vals=ch[1], diag=ch[2],
                                ncols=aux[0]),
)


# ----------------------------------------------------------------------
# bucketed multi-ELL: variable row widths without global-J padding
# ----------------------------------------------------------------------

BUCKET_EDGES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _build_buckets(indptr, indices, datas, n, dtype, bucket_edges):
    """Shared bucket construction: one sparsity pattern, ``len(datas)``
    aligned value sets.  Rows are grouped by nnz into buckets whose width is the
    smallest edge ≥ the row's nnz (the last bucket's width is the max nnz).
    Returns (buckets, sizes, rank): each bucket is ``(cols, [vals per
    data])`` over its own rows, and ``concat(bucket outputs)[rank]`` is the
    natural row order."""
    nnz = np.diff(indptr)
    edges = ([e for e in bucket_edges if e < int(nnz.max())]
             + [int(nnz.max())]) if n else []
    bidx = np.searchsorted(np.asarray(edges), nnz, side="left")
    perm = np.argsort(bidx, kind="stable")       # keeps first-touch order
    rank = np.empty(n, dtype=np.int64)
    rank[perm] = np.arange(n)

    buckets, sizes = [], []
    for b, edge in enumerate(edges):
        rows = perm[bidx[perm] == b]
        if len(rows) == 0:
            continue
        cols, valss = _ell_slab(indptr, indices, datas, rows, int(edge), n)
        buckets.append((jnp.asarray(cols, index_t()),
                        [jnp.asarray(v.astype(np.dtype(dtype)))
                         for v in valss]))
        sizes.append(len(rows))
    return tuple(buckets), tuple(sizes), jnp.asarray(rank, index_t())


@dataclasses.dataclass(frozen=True)
class MultiELLOperator:
    """Sparse operator as nnz-bucketed ELL slabs, NATURAL dof space.

    Higher-order simplex matrices have wildly variable row widths (o2 tets:
    mean 28, max 115 nnz/row) — one global-J ELL pads ~4×.  Here ROWS are
    grouped into same-width buckets (one weighted-gather slab each) while
    COLUMNS and the input vector stay in the natural numbering.  One final
    gather by ``rank`` unpermutes the concatenated bucket outputs back to
    natural row order, so callers see a plain natural-space operator.
    """

    buckets: tuple            # of (cols, vals) per bucket
    sizes: tuple              # rows per bucket (sum = n)
    rank: jnp.ndarray         # (n,) natural row -> concatenated-output slot
    diag: jnp.ndarray         # (n,) natural

    @property
    def shape(self):
        n = int(sum(self.sizes))
        return (n, n)

    @staticmethod
    def from_csr(A, dtype="float32",
                 bucket_edges=BUCKET_EDGES) -> "MultiELLOperator":
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        buckets, sizes, rank = _build_buckets(
            A.indptr, A.indices, [A.data], A.shape[0], dtype, bucket_edges)
        return MultiELLOperator(
            buckets=tuple((c, vs[0]) for c, vs in buckets), sizes=sizes,
            rank=rank, diag=jnp.asarray(A.diagonal().astype(np.dtype(dtype))))

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        outs = [_ell_apply(x, c, v) for c, v in self.buckets]
        return jnp.concatenate(outs)[self.rank]

    def diagonal(self) -> jnp.ndarray:
        return self.diag

    def operator(self) -> LinearOperator:
        return LinearOperator(shape=self.shape, mult=self.mult,
                              diagonal_fn=self.diagonal)


jax.tree_util.register_pytree_node(
    MultiELLOperator,
    lambda t: ((t.buckets, t.rank, t.diag), (t.sizes,)),
    lambda aux, ch: MultiELLOperator(
        buckets=ch[0], rank=ch[1], diag=ch[2], sizes=aux[0]),
)


@dataclasses.dataclass(frozen=True)
class MultiELLPair:
    """TWO matrices on one shared sparsity pattern, applied as
    ``y = (c0·W0 + c1·W1) x`` with the weight combination traced per SOLVE
    (one nnz-sized elementwise pass), not per iteration.

    The bioheat implicit stage operator (M_ρc + γ(K + M_ω)) is exactly this
    shape: M and A share the FE connectivity pattern, γ changes per solve.
    Reference analog: ``SparseMatrix::Add`` + ``Mult`` (linalg/sparsemat.cpp)
    without ever materializing the combined CSR.
    """

    buckets: tuple            # of (cols, (w0, w1)) per bucket
    sizes: tuple
    rank: jnp.ndarray
    diag0: jnp.ndarray        # (n,) natural diagonals of each matrix
    diag1: jnp.ndarray

    @property
    def shape(self):
        n = int(sum(self.sizes))
        return (n, n)

    @staticmethod
    def from_csr_pair(M0, M1, dtype="float32",
                      bucket_edges=BUCKET_EDGES) -> "MultiELLPair":
        import scipy.sparse as sp

        M0 = sp.csr_matrix(M0)
        M1 = sp.csr_matrix(M1)
        n = M0.shape[0]
        # union pattern with explicit zeros so both data arrays align
        P = (abs(M0) + abs(M1)).tocsr()
        P.sort_indices()

        def aligned(X):
            out = np.zeros(P.nnz, dtype=np.float64)
            X = X.tocsr()
            X.sort_indices()
            # for each entry of X find its slot in P by (row, col) key
            rows = np.repeat(np.arange(n), np.diff(X.indptr))
            big = np.int64(P.shape[1] + 1)
            pkeys = np.repeat(np.arange(n), np.diff(P.indptr)) * big \
                + P.indices
            slots = np.searchsorted(pkeys, rows * big + X.indices)
            out[slots] = X.data
            return out

        buckets, sizes, rank = _build_buckets(
            P.indptr, P.indices, [aligned(M0), aligned(M1)], n, dtype,
            bucket_edges)
        return MultiELLPair(
            buckets=tuple((c, (vs[0], vs[1])) for c, vs in buckets),
            sizes=sizes, rank=rank,
            diag0=jnp.asarray(M0.diagonal().astype(np.dtype(dtype))),
            diag1=jnp.asarray(M1.diagonal().astype(np.dtype(dtype))),
        )

    def mult_combined(self, x: jnp.ndarray, c0, c1) -> jnp.ndarray:
        """(c0·M0 + c1·M1) x — weights combined at trace time."""
        outs = [_ell_apply(x, c, c0 * w0 + c1 * w1)
                for c, (w0, w1) in self.buckets]
        return jnp.concatenate(outs)[self.rank]

    def mult0(self, x):
        return self.mult_combined(x, 1.0, 0.0)

    def mult1(self, x):
        return self.mult_combined(x, 0.0, 1.0)


jax.tree_util.register_pytree_node(
    MultiELLPair,
    lambda t: ((t.buckets, t.rank, t.diag0, t.diag1), (t.sizes,)),
    lambda aux, ch: MultiELLPair(
        buckets=ch[0], rank=ch[1], diag0=ch[2], diag1=ch[3],
        sizes=aux[0]),
)
