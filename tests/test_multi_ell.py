"""Bucketed multi-ELL SpMV (ops/ell.MultiELLOperator).

Variable-row-width matrices (higher-order simplex stencils) as permuted
nnz-bucketed weighted-gather slabs; y = A x must match scipy exactly up to
f32 rounding, including the row permutation round trip.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from cardiac_ablation_ecm2.ops.ell import MultiELLOperator


def _random_varwidth(n=700, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(n):
        # heavy-tailed row widths: mostly 5-20, a few up to 90
        k = int(rng.integers(3, 20))
        if rng.random() < 0.05:
            k = int(rng.integers(40, 90))
        c = rng.choice(n, size=min(k, n), replace=False)
        v = rng.standard_normal(len(c))
        rows += [r] * len(c)
        cols += list(c)
        vals += list(v)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def test_multi_ell_matches_scipy():
    A = _random_varwidth()
    op = MultiELLOperator.from_csr(A, dtype="float64")
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    y = np.asarray(op.mult(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.diag), A.diagonal(), rtol=1e-12)


def test_multi_ell_fem_matrix():
    import jax

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d_tet
    from cardiac_ablation_ecm2.ops.bilinearform import BilinearForm

    mesh = make_cartesian_3d_tet(4, 4, 4)
    fes = FESpace(mesh, 2)
    A = BilinearForm(fes).add_domain_integrator(
        "diffusion").assemble_matrix()
    op = MultiELLOperator.from_csr(A, dtype="float64")
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    y = np.asarray(op.mult(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-11, atol=1e-11)


def test_multi_ell_pair_combined():
    from cardiac_ablation_ecm2.ops.ell import MultiELLPair

    A = _random_varwidth(seed=3)
    B = _random_varwidth(seed=4)
    pair = MultiELLPair.from_csr_pair(A, B, dtype="float64")
    x = np.random.default_rng(5).standard_normal(A.shape[0])
    for c0, c1 in ((1.0, 0.0), (0.0, 1.0), (1.0, 0.37), (-2.0, 5.0)):
        y = np.asarray(pair.mult_combined(jnp.asarray(x), c0, c1))
        np.testing.assert_allclose(y, c0 * (A @ x) + c1 * (B @ x),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pair.diag0), A.diagonal())
    np.testing.assert_allclose(np.asarray(pair.diag1), B.diagonal())


def test_bioheat_ell_apply_matches_pa():
    """assembled_apply='ell' must reproduce the PA operator applies exactly
    (straight tets + constant coefficients: both quadratures are exact, so
    the operators are IDENTICAL up to rounding).  Full-step equivalence at
    cardiac scale is checked on the GPU by chip_smoke.py; this pins the
    applies."""
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d_tet
    from cardiac_ablation_ecm2.models import bioheat

    mesh = make_cartesian_3d_tet(5, 5, 5)
    kw = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
              ess_bdr=[1, 2, 3, 4, 5, 6], dtype="float64", theta_form=False)
    ops = {}
    for mode in ("off", "ell"):
        fes = FESpace(mesh, 2)
        ops[mode] = bioheat.BioheatOperator(fes=fes, assembled_apply=mode,
                                            **kw)
    v = jnp.asarray(
        np.random.default_rng(7).standard_normal(ops["off"].fes.ndof))
    for name, f in (
        ("Mrc", lambda o: o._Mrc_apply(v)),
        ("A", lambda o: o._A_apply(v)),
        ("lhs", lambda o: o._implicit_lhs_apply(jnp.float64(0.035), v)),
    ):
        a = np.asarray(f(ops["off"]))
        b = np.asarray(f(ops["ell"]))
        scale = np.abs(a).max()
        assert np.abs(a - b).max() < 1e-10 * scale, (
            f"{name}: {np.abs(a - b).max()} vs scale {scale}")
    # diagonals agree too (PA-restricted vs assembled)
    np.testing.assert_allclose(np.asarray(ops["off"].Mrc_diag),
                               np.asarray(ops["ell"]._ell.diag0),
                               rtol=1e-10)


def _bucket_cases():
    """A CSR matrix with the bucket edge cases."""
    rng = np.random.default_rng(11)
    n = 120
    # rows with exactly 0, and exactly 8 / 16 / 24 (= bucket edges) nnz,
    # plus one row one past an edge
    widths = np.array([0, 8, 16, 24, 25, 0, 7, 9] * (n // 8))
    rows = np.repeat(np.arange(n), widths)
    cols = np.concatenate([rng.choice(n, size=k, replace=False)
                           for k in widths])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, n))


@pytest.mark.parametrize("case", ["empty_rows", "rows_at_edges",
                                  "f32_vs_f64"])
def test_ell_buckets(case):
    from cardiac_ablation_ecm2.ops.ell import BUCKET_EDGES, _build_buckets

    A = _bucket_cases()
    nnz = np.diff(A.indptr)
    x = np.random.default_rng(12).standard_normal(A.shape[0])
    if case == "empty_rows":
        op = MultiELLOperator.from_csr(A, dtype="float64")
        y = np.asarray(op.mult(jnp.asarray(x)))
        assert np.all(y[nnz == 0] == 0.0)
        np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)
        # an all-empty matrix has one zero-width bucket and applies to 0
        Z = sp.csr_matrix((5, 5))
        z = MultiELLOperator.from_csr(Z, dtype="float64")
        assert np.all(np.asarray(z.mult(jnp.ones(5))) == 0.0)
    elif case == "rows_at_edges":
        buckets, sizes, rank = _build_buckets(
            A.indptr, A.indices, [A.data], A.shape[0], "float64",
            BUCKET_EDGES)
        widths = [int(c.shape[0]) for c, _ in buckets]
        # a row of exactly `edge` nnz lands in that edge's bucket (no pad)
        assert widths == [8, 16, 24, 25]
        assert sizes == (int(np.sum(nnz <= 8)),
                         int(np.sum((nnz > 8) & (nnz <= 16))),
                         int(np.sum(nnz == 24)), int(np.sum(nnz == 25)))
        assert sorted(np.asarray(rank).tolist()) == list(range(A.shape[0]))
        op = MultiELLOperator.from_csr(A, dtype="float64")
        np.testing.assert_allclose(np.asarray(op.mult(jnp.asarray(x))),
                                   A @ x, rtol=1e-12, atol=1e-12)
    else:
        y64 = np.asarray(MultiELLOperator.from_csr(A, dtype="float64")
                         .mult(jnp.asarray(x)))
        op32 = MultiELLOperator.from_csr(A, dtype="float32")
        assert all(v.dtype == jnp.float32 for _, v in op32.buckets)
        y32 = np.asarray(op32.mult(jnp.asarray(x, jnp.float32)))
        assert y32.dtype == np.float32
        # f32 rounding of ≤25-term sums of O(1) products
        scale = np.abs(A) @ np.abs(x)
        assert np.all(np.abs(y32 - y64) <= 1e-5 * scale + 1e-30)
