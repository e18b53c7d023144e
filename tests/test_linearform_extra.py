"""Extra linear-form integrators: (f,∇v) and (f·n, v)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import (
    boundary_normal_lf,
    domain_lf_grad,
)


def test_domain_lf_grad_identity_3d():
    """f = ∇u with u in the space ⇒ (f, ∇v) == (∇u, ∇v) = A u."""
    mesh = make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, 2)

    def u_ex(x):
        return x[..., 0] ** 2 + 0.5 * x[..., 1] * x[..., 2] - x[..., 2]

    def grad_u(x):
        return np.stack([
            2 * x[..., 0],
            0.5 * x[..., 2],
            0.5 * x[..., 1] - 1.0,
        ], axis=-1)

    u = project(fes, u_ex)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    b1 = np.asarray(A.mult(u))
    b2 = np.asarray(domain_lf_grad(fes, grad_u))
    assert np.abs(b1 - b2).max() < 1e-10 * np.abs(b1).max()


def test_domain_lf_grad_constant_2d():
    """Constant f: (f,∇v) sums to 0 over all dofs (∇ of partition of unity)."""
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 3)
    b = np.asarray(domain_lf_grad(fes, np.array([1.0, -2.0])))
    assert abs(b.sum()) < 1e-12
    # divergence theorem: Σ_i b_i φ_i with v=x gives ∫ f·(1,0) = f_x |Ω|
    x = np.asarray(project(fes, lambda p: p[..., 0]))
    assert np.isclose(float(b @ x), 1.0, atol=1e-10)


def test_boundary_normal_lf_divergence_theorem():
    """v ≡ 1: ∮ f·n = ∫ div f; take f = (x, y, z) ⇒ ∮ f·n = 3|Ω| = 3."""
    mesh = make_cartesian_3d(2, 2, 2)
    fes = FESpace(mesh, 2)
    b = np.asarray(boundary_normal_lf(fes, lambda x: np.asarray(x)))
    assert np.isclose(b.sum(), 3.0, atol=1e-10), b.sum()


def test_boundary_normal_lf_marker_2d():
    """f = (1,0), only the x=1 side marked: ∮ f·n = length = 1."""
    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2)
    # cartesian 2D bdr attributes: 1=bottom,2=right,3=top,4=left
    b = np.asarray(boundary_normal_lf(fes, np.array([1.0, 0.0]),
                                      bdr_marker=(2,)))
    assert np.isclose(b.sum(), 1.0, atol=1e-10), b.sum()
    b4 = np.asarray(boundary_normal_lf(fes, np.array([1.0, 0.0]),
                                       bdr_marker=(4,)))
    assert np.isclose(b4.sum(), -1.0, atol=1e-10), b4.sum()


def test_delta_lf_pairing():
    """b·u = Σ s_k u(x_k) exactly for in-space u (ex34 delta loads)."""
    from cardiac_ablation_ecm2.mesh.point_eval import evaluate_at_points
    from cardiac_ablation_ecm2.ops.linearform import delta_lf

    fes = FESpace(make_cartesian_2d(4, 4), 3)
    pts = [[0.33, 0.61], [0.9, 0.1], [5.0, 5.0]]   # last one outside
    b = delta_lf(fes, pts, [2.5, -1.0, 7.0])
    u = project(fes, lambda x: np.asarray(x)[..., 0] ** 3
                - 2 * np.asarray(x)[..., 1])
    vals = evaluate_at_points(fes, np.asarray(u), pts)
    expect = 2.5 * vals[0] - 1.0 * vals[1]          # outside point ignored
    assert abs(float(b @ u) - expect) < 1e-12


def test_boundary_tangential_circulation_2d():
    """∮ (g·τ) v ds with v ≡ 1 (H1 PoU) = circulation of g = ∫∫ curl g dA
    by Green's theorem — checks orientation (CCW boundary storage) AND
    magnitude.  g = (−y, x): curl g = 2 ⇒ b·1 = 2·Area."""
    from cardiac_ablation_ecm2.ops.linearform import boundary_tangential_lf

    mesh = make_cartesian_2d(4, 4, 2.0, 1.5)
    fes = FESpace(mesh, 2)

    def g(x):
        return np.stack([-x[..., 1], x[..., 0]], axis=-1)

    b = boundary_tangential_lf(fes, g)
    assert np.isclose(float(jnp.sum(b)), 2.0 * 2.0 * 1.5, rtol=1e-10)


def test_boundary_tangential_exact_line_integral():
    """b·u for projected smooth v vs an independent numpy line-integral of
    ∮ (g·τ) v ds along the four sides of [0,1]² (CCW)."""
    from numpy.polynomial.legendre import leggauss

    from cardiac_ablation_ecm2.ops.linearform import boundary_tangential_lf

    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 3)

    def g(x):
        return np.stack([x[..., 1] ** 2, x[..., 0] * x[..., 1]], axis=-1)

    def v(x):
        return 1.0 + x[..., 0] ** 2 - 0.5 * x[..., 1]

    b = boundary_tangential_lf(fes, g)
    u = project(fes, v)
    got = float(b @ u)

    xg, wg = leggauss(12)
    s = 0.5 * (xg + 1.0)
    ws = 0.5 * wg
    # CCW sides: bottom (t=+x̂), right (+ŷ), top (−x̂), left (−ŷ)
    sides = [
        (np.stack([s, 0 * s], 1), np.array([1.0, 0.0])),
        (np.stack([0 * s + 1, s], 1), np.array([0.0, 1.0])),
        (np.stack([1 - s, 0 * s + 1], 1), np.array([-1.0, 0.0])),
        (np.stack([0 * s, 1 - s], 1), np.array([0.0, -1.0])),
    ]
    want = sum(float(np.sum(ws * (g(x) @ t) * v(x))) for x, t in sides)
    assert np.isclose(got, want, rtol=1e-9)


def test_vector_quadrature_lf_matches_per_component():
    from cardiac_ablation_ecm2.fem.build import geom_factors_for
    from cardiac_ablation_ecm2.ops.linearform import (
        domain_lf_from_qvec,
        vector_quadrature_lf,
    )

    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2)
    gf = geom_factors_for(fes)
    rng = np.random.default_rng(0)
    fq = jnp.asarray(rng.standard_normal(gf.det.shape + (2,)))
    b = vector_quadrature_lf(fes, fq)
    nds = fes.ndof_scalar
    for c in range(2):
        bc = domain_lf_from_qvec(fes, fq[..., c])
        np.testing.assert_allclose(np.asarray(b[c * nds:(c + 1) * nds]),
                                   np.asarray(bc), rtol=1e-12, atol=1e-14)


def test_white_noise_covariance_is_mass_matrix():
    """E[b bᵀ] = M exactly (lininteg.hpp:664 docblock: H Hᵀ = Pᵀ diag(M_e) P
    = M); checked by Monte-Carlo sample covariance against the assembled
    mass matrix, plus determinism in the key."""
    from cardiac_ablation_ecm2.ops.linearform import white_noise_lf

    mesh = make_cartesian_2d(2, 2)
    fes = FESpace(mesh, 1)
    M = BilinearForm(fes).add_domain_integrator("mass").assemble()
    Md = np.column_stack([
        np.asarray(M.mult(jnp.eye(fes.ndof_scalar)[:, j]))
        for j in range(fes.ndof_scalar)
    ])

    nsam = 40000
    b = np.asarray(white_noise_lf(fes, 0, num=nsam), dtype=np.float64)
    cov = b.T @ b / nsam
    scale = np.abs(Md).max()
    assert np.abs(cov - Md).max() < 0.03 * scale

    b1 = np.asarray(white_noise_lf(fes, 7))
    b2 = np.asarray(white_noise_lf(fes, 7))
    b3 = np.asarray(white_noise_lf(fes, 8))
    np.testing.assert_array_equal(b1, b2)
    assert np.abs(b1 - b3).max() > 0
