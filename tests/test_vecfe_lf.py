"""Vector-FE linear forms against derivative bases.

VectorFEDomainLFCurl (f, curl v) and VectorFEDomainLFDiv (f, div v)
(reference fem/lininteg.hpp:393/:417), validated by the duality identity
b·x_E = ∫ f · curl(E_h) (resp. ∫ f div F_h) with E_h an exact L2
projection of a representable polynomial field, so the integral has a
closed form.
"""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
    vecfe_linear_form_curl,
    vecfe_linear_form_div,
)


def l2_project(op, field):
    b = vecfe_linear_form(op, field)
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=2000)
    assert info.converged
    return x


def test_curl_linear_form_duality():
    mesh = make_cartesian_3d(3, 3, 3)
    sp = NDSpace(mesh)
    M = build_nd_operator(sp, mass_coeff=1.0)
    A = build_nd_operator(sp, mass_coeff=1.0, curlcurl_coeff=1.0)

    # E = (yz, 0, 0) is in ND0 on hexes; curl E = (0, y, -z)
    def E(x):
        out = np.zeros_like(x)
        out[..., 0] = x[..., 1] * x[..., 2]
        return out

    xE = l2_project(M, E)
    f = np.array([1.0, 2.0, 3.0])
    b = vecfe_linear_form_curl(A, lambda x: np.broadcast_to(f, x.shape))
    # ∫ f·curl E over unit cube = 2*∫y - 3*∫z = 2*(1/2) - 3*(1/2) = -1/2
    got = float(jnp.dot(b, xE))
    assert abs(got - (-0.5)) < 1e-10


def test_div_linear_form_duality():
    mesh = make_cartesian_3d(3, 3, 3)
    sp = RTSpace(mesh)
    M = build_rt_operator(sp, mass_coeff=1.0)
    A = build_rt_operator(sp, mass_coeff=1.0, divdiv_coeff=1.0)

    # F = (x, y, z) is in RT0 on hexes; div F = 3
    def F(x):
        return np.asarray(x)

    xF = l2_project(M, F)
    b = vecfe_linear_form_div(A, lambda x: np.asarray(x)[..., 0])
    # ∫ x * div F = 3 * ∫x = 3/2 over the unit cube
    got = float(jnp.dot(b, xF))
    assert abs(got - 1.5) < 1e-10


def test_missing_term_raises():
    mesh = make_cartesian_3d(2, 2, 2)
    sp = NDSpace(mesh)
    M = build_nd_operator(sp, mass_coeff=1.0)
    try:
        vecfe_linear_form_curl(M, lambda x: x)
    except ValueError as e:
        assert "curlcurl" in str(e)
    else:
        raise AssertionError("expected ValueError")


def test_nd_boundary_tangent_constant_duality():
    """∮ (n×c)·v dS = −∫ c·(∇×v) dV for constant c (Stokes):
    b == −vecfe_linear_form_curl(op, c) exactly, on hexes AND tets —
    validates chart rotation, outward signs, and edge orientation signs."""
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d_tet
    from cardiac_ablation_ecm2.ops.vecfe import nd_boundary_tangent_lf

    c = np.array([0.3, -1.1, 0.7])
    for mesh in [make_cartesian_3d(3, 3, 3), make_cartesian_3d_tet(2, 2, 2)]:
        sp = NDSpace(mesh)
        op = build_nd_operator(sp, mass_coeff=1.0, curlcurl_coeff=1.0)
        b = nd_boundary_tangent_lf(sp, c)
        want = -np.asarray(vecfe_linear_form_curl(op, lambda x: 0 * x + c))
        np.testing.assert_allclose(np.asarray(b), want, rtol=0, atol=1e-12)


def test_nd_boundary_tangent_smooth_field_identity():
    """∇·(f×v) identity: ∮ (n×f)·v dS = (∇×f, v) − (f, ∇×v) for
    polynomial f (exact quadrature).  f = (y², 0, 0), ∇×f = (0, 0, −2y)."""
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d_tet
    from cardiac_ablation_ecm2.ops.vecfe import nd_boundary_tangent_lf

    def f(x):
        return np.stack([x[..., 1] ** 2, 0 * x[..., 0], 0 * x[..., 0]],
                        axis=-1)

    def curl_f(x):
        return np.stack([0 * x[..., 0], 0 * x[..., 0], -2 * x[..., 1]],
                        axis=-1)

    for mesh in [make_cartesian_3d(2, 3, 2), make_cartesian_3d_tet(2, 2, 2)]:
        sp = NDSpace(mesh)
        op = build_nd_operator(sp, mass_coeff=1.0, curlcurl_coeff=1.0)
        b = nd_boundary_tangent_lf(sp, f)
        want = (np.asarray(vecfe_linear_form(op, curl_f))
                - np.asarray(vecfe_linear_form_curl(op, f)))
        np.testing.assert_allclose(np.asarray(b), want, rtol=0, atol=1e-12)


def test_nd_boundary_tangent_marker_subset():
    """Marked-attribute assembly touches only dofs of the marked faces and
    the all-markers sum equals the unmarked call."""
    from cardiac_ablation_ecm2.ops.vecfe import nd_boundary_tangent_lf

    mesh = make_cartesian_3d(2, 2, 2)
    sp = NDSpace(mesh)

    def f(x):
        return np.stack([x[..., 2], x[..., 0], x[..., 1]], axis=-1)

    ball = np.asarray(nd_boundary_tangent_lf(sp, f))
    parts = sum(
        np.asarray(nd_boundary_tangent_lf(sp, f, bdr_marker=[a]))
        for a in np.unique(mesh.bdr_attributes)
    )
    np.testing.assert_allclose(parts, ball, rtol=0, atol=1e-13)
    assert np.abs(ball).max() > 0
