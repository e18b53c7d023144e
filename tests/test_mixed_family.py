"""The cross/dot/directional mixed-integrator family
(MixedDotProduct / MixedVectorProduct / MixedCrossProduct /
MixedScalarCrossProduct / MixedDirectionalDerivative / MixedGradGrad /
MixedCrossGradGrad analogs, ops/mixed_vecfe.py) — validated by exact
polynomial quadrature identities and adjoint/antisymmetry structure."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf, domain_lf_vector
from cardiac_ablation_ecm2.ops.mixed_vecfe import (
    mixed_cross_grad_grad, mixed_cross_product, mixed_directional_derivative,
    mixed_dot_product, mixed_grad_grad, mixed_scalar_cross_product,
    mixed_vector_product)


def _interp_vec(vfes, fns):
    X = np.asarray(vfes.dof_coords)
    return jnp.asarray(np.concatenate([f(X) for f in fns]))


def test_dot_product_polynomial():
    mesh = make_cartesian_2d(3, 3)
    V2 = FESpace(mesh, 2, vdim=2)
    Q = FESpace(mesh, 2)
    V = np.array([2.0, 3.0])
    op = mixed_dot_product(V2, Q, V)
    u = _interp_vec(V2, [lambda X: X[:, 0] ** 2, lambda X: X[:, 0] * X[:, 1]])
    got = np.asarray(op.mult(u))
    want = np.asarray(domain_lf(
        Q, lambda x: 2 * x[..., 0] ** 2 + 3 * x[..., 0] * x[..., 1],
        nq1d=4))
    assert np.allclose(got, want, atol=1e-13)


def test_vector_product_is_dot_adjoint():
    mesh = make_cartesian_2d(3, 3)
    V2 = FESpace(mesh, 2, vdim=2)
    Q = FESpace(mesh, 1)
    V = np.array([0.7, -1.3])
    dot_op = mixed_dot_product(V2, Q, V)
    vp_op = mixed_vector_product(Q, V2, V)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(V2.ndof))
    q = jnp.asarray(rng.standard_normal(Q.ndof_scalar))
    a = float(dot_op.mult(u) @ q)
    b = float(u @ vp_op.mult(q))
    assert abs(a - b) < 1e-12 * max(abs(a), 1.0)


def test_scalar_cross_product_polynomial():
    mesh = make_cartesian_2d(3, 3)
    V2 = FESpace(mesh, 2, vdim=2)
    Q = FESpace(mesh, 2)
    V = np.array([2.0, 3.0])
    op = mixed_scalar_cross_product(V2, Q, V)
    u = _interp_vec(V2, [lambda X: X[:, 0] ** 2, lambda X: X[:, 0] * X[:, 1]])
    # V × u = V_x u_y − V_y u_x = 2xy − 3x²
    got = np.asarray(op.mult(u))
    want = np.asarray(domain_lf(
        Q, lambda x: 2 * x[..., 0] * x[..., 1] - 3 * x[..., 0] ** 2,
        nq1d=4))
    assert np.allclose(got, want, atol=1e-13)


def test_cross_product_3d_polynomial():
    mesh = make_cartesian_3d(2, 2, 2)
    V3 = FESpace(mesh, 1, vdim=3)
    V = np.array([1.0, 2.0, 3.0])
    op = mixed_cross_product(V3, V3, V)
    u = _interp_vec(V3, [lambda X: X[:, 2], lambda X: X[:, 0],
                         lambda X: X[:, 1]])
    got = np.asarray(op.mult(u))
    want = np.asarray(domain_lf_vector(
        V3, lambda x: np.stack([
            2 * x[..., 1] - 3 * x[..., 0],
            3 * x[..., 2] - 1 * x[..., 1],
            1 * x[..., 0] - 2 * x[..., 2]], axis=-1), nq1d=3))
    assert np.allclose(got, want, atol=1e-13)


def test_directional_derivative_polynomial():
    mesh = make_cartesian_2d(3, 3)
    S = FESpace(mesh, 2)
    Q = FESpace(mesh, 1)
    V = np.array([2.0, 3.0])
    op = mixed_directional_derivative(S, Q, V)
    X = np.asarray(S.dof_coords)
    u = jnp.asarray(X[:, 0] ** 2 + X[:, 1])
    got = np.asarray(op.mult(u))
    want = np.asarray(domain_lf(Q, lambda x: 4 * x[..., 0] + 3.0, nq1d=4))
    assert np.allclose(got, want, atol=1e-13)


def test_grad_grad_matches_diffusion():
    mesh = make_cartesian_2d(3, 3)
    S = FESpace(mesh, 2)
    M = mixed_grad_grad(S, S, coeff=1.7).assemble_matrix()
    A = BilinearForm(S, nq1d=4).add_domain_integrator(
        "diffusion", coeff=1.7).assemble_matrix()
    assert abs(M - A).max() < 1e-12


def test_cross_grad_grad_antisymmetric():
    mesh = make_cartesian_3d(2, 2, 2)
    S = FESpace(mesh, 2)
    V = np.array([0.4, -1.1, 0.8])
    op = mixed_cross_grad_grad(S, S, V)
    M = op.assemble_matrix().toarray()
    assert np.abs(M + M.T).max() < 1e-13
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(S.ndof_scalar))
    assert abs(float(op.mult(u) @ u)) < 1e-11


def test_cross_curl_polynomial():
    """(V × curl u, w) on ND1: u = (z, x, y) has curl = (1, 1, 1), so the
    result is the constant field V × (1,1,1)."""
    from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
    from cardiac_ablation_ecm2.ops.mixed_vecfe import mixed_cross_curl
    from cardiac_ablation_ecm2.ops.vecfe import (build_nd_operator,
                                                     vecfe_linear_form)

    mesh = make_cartesian_3d(2, 2, 2)
    nd = NDSpaceHO(mesh, 1)
    V3 = FESpace(mesh, 1, vdim=3)
    V = np.array([1.0, 2.0, 3.0])

    # project u = (z, x, y) onto ND via a mass solve
    from cardiac_ablation_ecm2.linalg.solvers import cg

    op = build_nd_operator(nd, mass_coeff=1.0, nq1d=3)
    b = vecfe_linear_form(op, lambda x: np.stack(
        [x[..., 2], x[..., 0], x[..., 1]], axis=-1))
    u, info = cg(op.mult, b, M=lambda r: r / op.diagonal(), rel_tol=1e-13,
                 max_iter=2000)
    assert bool(info.converged)

    cc = mixed_cross_curl(nd, V3, V, nq1d=3)
    got = np.asarray(cc.mult(u))
    w = np.cross(V, np.array([1.0, 1.0, 1.0]))
    want = np.asarray(domain_lf_vector(V3, w, nq1d=3))
    assert np.allclose(got, want, atol=1e-10)


def test_cross_grad_polynomial():
    """(V × ∇u, w) with u = x + 2y + 3z: ∇u constant, result constant."""
    from cardiac_ablation_ecm2.ops.mixed_vecfe import mixed_cross_grad

    mesh = make_cartesian_3d(2, 2, 2)
    S = FESpace(mesh, 1)
    V3 = FESpace(mesh, 1, vdim=3)
    V = np.array([0.5, -1.0, 2.0])
    X = np.asarray(S.dof_coords)
    u = jnp.asarray(X[:, 0] + 2 * X[:, 1] + 3 * X[:, 2])
    op = mixed_cross_grad(S, V3, V)
    got = np.asarray(op.mult(u))
    want = np.asarray(domain_lf_vector(
        V3, np.cross(V, np.array([1.0, 2.0, 3.0])), nq1d=3))
    assert np.allclose(got, want, atol=1e-12)


def test_scalar_weak_divergence_adjoint():
    """−(V u, ∇w) is the negative adjoint of the directional derivative
    (V·∇w, u)."""
    from cardiac_ablation_ecm2.ops.mixed_vecfe import (
        mixed_scalar_weak_divergence)

    mesh = make_cartesian_2d(3, 3)
    S = FESpace(mesh, 1)
    T = FESpace(mesh, 2)
    V = np.array([1.5, -0.5])
    wd = mixed_scalar_weak_divergence(S, T, V, nq1d=4)
    dd = mixed_directional_derivative(T, S, V, nq1d=4)
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal(S.ndof_scalar))
    w = jnp.asarray(rng.standard_normal(T.ndof_scalar))
    a = float(wd.mult(u) @ w)
    b = float(u @ dd.mult(w))
    assert abs(a + b) < 1e-12 * max(abs(a), 1.0)
