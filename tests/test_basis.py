"""Basis correctness (reference analog: tests/unit/fem/test_calcshape.cpp etc.):
partition of unity, nodal interpolation (Kronecker delta), exact reproduction
of polynomials up to order p, and tensor/dense cross-checks."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import basis
from cardiac_ablation_ecm2.fem.geometry import Geometry, DIMENSION


GEOMS = [Geometry.SEGMENT, Geometry.SQUARE, Geometry.CUBE, Geometry.TRIANGLE,
         Geometry.TETRAHEDRON]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_partition_of_unity_and_delta(geom, p):
    d2q = basis.make_dof_to_quad(geom, p)
    B = d2q.full_B()
    G = d2q.full_G()
    # partition of unity: sum_i L_i(x) = 1, sum_i ∇L_i = 0
    assert np.allclose(B.sum(axis=1), 1.0, atol=1e-12)
    assert np.allclose(G.sum(axis=1), 0.0, atol=1e-10)
    # Kronecker delta at the nodes
    nodes = basis.h1_nodes(geom, p)
    if d2q.tensor:
        Bn, _ = basis.lagrange_matrices(basis.h1_nodes_1d(p), basis.h1_nodes_1d(p))
        assert np.allclose(Bn, np.eye(p + 1), atol=1e-12)
    else:
        Bn, _ = basis.simplex_basis_matrices(geom, p, nodes)
        assert np.allclose(Bn, np.eye(len(nodes)), atol=1e-10)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("p", [1, 3])
def test_polynomial_reproduction(geom, p):
    """Interpolating x^a y^b z^c (total/each degree ≤ p) is exact at quad pts."""
    d2q = basis.make_dof_to_quad(geom, p)
    dim = DIMENSION[geom]
    nodes = basis.h1_nodes(geom, p)
    B, G = d2q.full_B(), d2q.full_G()
    pts = d2q.points

    powers = np.zeros(dim, dtype=int)
    powers[0] = p
    if dim > 1 and not d2q.tensor:
        powers = np.array([p // 2, p - p // 2] + [0] * (dim - 2))

    def f(x):
        return np.prod(x**powers, axis=-1)

    u = f(nodes)
    assert np.allclose(B @ u, f(pts), atol=1e-11)
    # gradient check on first axis
    dpow = powers.copy()
    dpow[0] = max(dpow[0] - 1, 0)
    df = powers[0] * np.prod(pts**dpow, axis=-1)
    assert np.allclose(G[:, :, 0] @ u, df, atol=1e-10)


@pytest.mark.parametrize("p", [2, 4])
def test_lex_kron_matches_pointwise(p):
    """full_B entries equal products of 1D evaluations at the lex-ordered points."""
    d2q = basis.make_dof_to_quad(Geometry.SQUARE, p)
    B = d2q.full_B()
    nq1, n1 = d2q.B1.shape
    for q in [0, 3, nq1 * nq1 - 1]:
        qx, qy = q % nq1, q // nq1
        for i in [0, 1, n1 * n1 - 1]:
            ix, iy = i % n1, i // n1
            assert np.isclose(B[q, i], d2q.B1[qx, ix] * d2q.B1[qy, iy])


def test_bernstein_positive_basis():
    """Bernstein basis: positivity, partition of unity, exact P_p
    representation via the nodal→Bernstein conversion."""
    from cardiac_ablation_ecm2.fem.basis import (
        bernstein_matrices,
        h1_nodes_1d,
        nodal_to_bernstein,
    )

    p = 4
    x = np.linspace(0, 1, 33)
    B, G = bernstein_matrices(p, x)
    assert (B >= -1e-14).all()                        # positivity
    assert np.abs(B.sum(axis=1) - 1).max() < 1e-13    # partition of unity
    assert np.abs(G.sum(axis=1)).max() < 1e-12

    # exact representation of a degree-p polynomial
    f = lambda t: 2 * t**4 - t**2 + 0.3              # noqa: E731
    v = f(h1_nodes_1d(p))                            # nodal values
    c = nodal_to_bernstein(p) @ v                    # Bernstein coeffs
    assert np.abs(B @ c - f(x)).max() < 1e-12

    # derivative consistency (finite differences)
    h = 1e-6
    Bp, _ = bernstein_matrices(p, x + h)
    Bm, _ = bernstein_matrices(p, x - h)
    assert np.abs((Bp - Bm) / (2 * h) - G).max() < 1e-6
