"""Quadrature exactness tests (reference analog: tests/unit/fem intrule checks)."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import intrules


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_gauss_legendre_exactness(n):
    x, w = intrules.gauss_legendre_1d(n)
    assert np.isclose(w.sum(), 1.0)
    for d in range(2 * n):  # exact through degree 2n-1
        exact = 1.0 / (d + 1)
        assert np.isclose(w @ x**d, exact, atol=1e-14), d


@pytest.mark.parametrize("n", [2, 3, 4, 6, 9])
def test_gauss_lobatto_exactness(n):
    x, w = intrules.gauss_lobatto_1d(n)
    assert np.isclose(x[0], 0.0) and np.isclose(x[-1], 1.0)
    for d in range(2 * n - 2):  # exact through degree 2n-3
        assert np.isclose(w @ x**d, 1.0 / (d + 1), atol=1e-13), d


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_tensor_rule_volume_and_ordering(dim):
    pts, wts = intrules.tensor_rule(dim, 3)
    assert np.isclose(wts.sum(), 1.0)
    # lexicographic: first coordinate varies fastest
    if dim > 1:
        assert not np.isclose(pts[0, 0], pts[1, 0])
        assert np.isclose(pts[0, 1], pts[1, 1])
    # exactness of a mixed monomial
    f = np.prod(pts**2, axis=1)
    assert np.isclose(wts @ f, (1.0 / 3.0) ** dim, atol=1e-14)


@pytest.mark.parametrize("alpha", [1, 2])
def test_gauss_jacobi(alpha):
    x, w = intrules.gauss_jacobi_1d(4, alpha)
    for d in range(2 * 4):
        # ∫_0^1 (1-x)^alpha x^d dx = B(d+1, alpha+1)
        from math import factorial

        exact = factorial(d) * factorial(alpha) / factorial(d + alpha + 1)
        assert np.isclose(w @ x**d, exact, atol=1e-14), d


@pytest.mark.parametrize("dim,order", [(2, 2), (2, 5), (3, 2), (3, 5)])
def test_simplex_rule(dim, order):
    pts, wts = intrules.simplex_rule(dim, order)
    vol = 0.5 if dim == 2 else 1.0 / 6.0
    assert np.isclose(wts.sum(), vol, atol=1e-14)
    assert np.all(pts >= -1e-14) and np.all(pts.sum(axis=1) <= 1 + 1e-14)
    # exactness on monomials up to `order`
    from math import factorial

    for powers in [(order, 0, 0), (order // 2, order - order // 2, 0), (1, 1, max(order - 2, 0))]:
        p = powers[:dim] if dim == 3 else powers[:2]
        if sum(p) > order:
            continue
        f = np.ones(len(pts))
        for d, pw in enumerate(p):
            f *= pts[:, d] ** pw
        # ∫_simplex x^a y^b z^c = a! b! c! / (a+b+c+dim)!
        exact = np.prod([factorial(k) for k in p]) / factorial(sum(p) + dim)
        assert np.isclose(wts @ f, exact, atol=1e-13), p
