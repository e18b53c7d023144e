"""H(curl)/H(div) lowest-order spaces: constant-field reproduction (exact on
trilinear maps), de Rham identity curl∘grad = 0, flux exactness, and an
ex3-style curl-curl solve."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    discrete_gradient,
    vecfe_linear_form,
)
from test_fespace import permute_vertices, perturb


def pmesh3():
    return perturb(permute_vertices(make_cartesian_3d(3, 3, 3), 2), amount=0.1)


def pmesh2():
    return perturb(permute_vertices(make_cartesian_2d(4, 4), 3), amount=0.1)


@pytest.mark.parametrize("dim", [2, 3])
def test_nd_constant_field_reproduction(dim):
    """Project E = c via the ND0 mass matrix: energy must equal |c|²·|Ω| and
    curl energy must vanish — exact even on perturbed (trilinear) meshes."""
    mesh = pmesh3() if dim == 3 else pmesh2()
    sp = NDSpace(mesh)
    M = build_nd_operator(sp, mass_coeff=1.0)
    CC = build_nd_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)
    c = np.array([1.0, -0.5, 0.25][:dim])

    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    diag = M.diagonal()
    u, info = cg(M.mult, b, M=lambda r: r / diag, rel_tol=1e-13, max_iter=2000)
    assert bool(info.converged)
    energy = float(jnp.vdot(u, M.mult(u)))
    vol = float(jnp.sum(M.gf.wdet))
    assert np.isclose(energy, np.dot(c, c) * vol, rtol=1e-9), (
        energy, np.dot(c, c) * vol
    )
    curl_energy = float(jnp.vdot(u, CC.mult(u)))
    assert abs(curl_energy) < 1e-9, curl_energy


@pytest.mark.parametrize("dim", [2, 3])
def test_de_rham_curl_grad_zero(dim):
    """curl(grad u) = 0: the curl-curl operator annihilates discrete
    gradients — exercises every edge sign and orientation."""
    mesh = pmesh3() if dim == 3 else pmesh2()
    sp = NDSpace(mesh)
    h1 = FESpace(mesh, 1)
    G = discrete_gradient(h1, sp)
    CC = build_nd_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.random(h1.ndof_scalar))
    r = CC.mult(G(u))
    assert np.abs(np.asarray(r)).max() < 1e-11, np.abs(np.asarray(r)).max()


@pytest.mark.parametrize("dim", [2, 3])
def test_rt_constant_field_and_divfree(dim):
    # NOTE: RT0 under the Piola map reproduces constants only on affine /
    # parallelepiped elements (classic result), so this exactness test uses a
    # vertex-permuted Cartesian mesh — which still stresses every
    # orientation-sign path — rather than a perturbed one.
    mesh = (permute_vertices(make_cartesian_3d(3, 3, 3), 2) if dim == 3
            else permute_vertices(make_cartesian_2d(4, 4), 3))
    sp = RTSpace(mesh)
    M = build_rt_operator(sp, mass_coeff=1.0)
    DD = build_rt_operator(sp, mass_coeff=None, divdiv_coeff=1.0)
    c = np.array([0.7, 0.2, -0.4][:dim])
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    diag = M.diagonal()
    u, info = cg(M.mult, b, M=lambda r: r / diag, rel_tol=1e-13, max_iter=2000)
    assert bool(info.converged)
    energy = float(jnp.vdot(u, M.mult(u)))
    vol = float(jnp.sum(M.gf.wdet))
    assert np.isclose(energy, np.dot(c, c) * vol, rtol=1e-9)
    div_energy = float(jnp.vdot(u, DD.mult(u)))
    assert abs(div_energy) < 1e-9, div_energy


def test_nd_definite_maxwell_solve():
    """ex3-style: (curl E, curl F) + (E, F) = (f, F) with f = const is solved
    by the constant field (natural BCs): verify the solver recovers it."""
    mesh = make_cartesian_3d(3, 3, 3)
    sp = NDSpace(mesh)
    A = build_nd_operator(sp, mass_coeff=1.0, curlcurl_coeff=1.0)
    c = np.array([1.0, 2.0, -1.0])
    b = vecfe_linear_form(A, lambda x: np.broadcast_to(c, x.shape))
    diag = A.diagonal()
    u, info = cg(A.mult, b, M=lambda r: r / diag, rel_tol=1e-13, max_iter=3000)
    assert bool(info.converged)
    # solution energy equals |c|^2 vol (E = c solves the PDE with curl E = 0)
    energy = float(jnp.vdot(u, b))
    assert np.isclose(energy, np.dot(c, c) * 1.0, rtol=1e-8), energy


def test_pa_matches_assembled_vecfe():
    mesh = pmesh3()
    for A in (
        build_nd_operator(NDSpace(mesh), mass_coeff=2.0, curlcurl_coeff=0.5),
        build_rt_operator(RTSpace(mesh), mass_coeff=1.5, divdiv_coeff=0.7),
    ):
        Amat = A.assemble_matrix()
        rng = np.random.default_rng(5)
        x = rng.random(A.ndof)
        assert np.allclose(
            np.asarray(A.mult(jnp.asarray(x))), Amat @ x, atol=1e-11
        )
        assert np.allclose(
            np.asarray(A.diagonal()), Amat.diagonal(), atol=1e-11
        )


def test_de_rham_div_curl_zero():
    """div(curl E) = 0: the RT0 incidence divergence annihilates discrete
    curls of arbitrary ND0 fields (full de Rham chain with grad)."""
    from cardiac_ablation_ecm2.ops.vecfe import discrete_curl

    mesh = pmesh3()
    nd = NDSpace(mesh)
    rt = RTSpace(mesh)
    C = discrete_curl(nd, rt)
    rng = np.random.default_rng(7)
    E = jnp.asarray(rng.random(nd.ndof))
    u = C(E)
    # incidence divergence: per element, signed sum of face dofs
    div = np.einsum(
        "ef,ef->e", np.asarray(u)[rt.gather_map], rt.signs
    )
    assert np.abs(div).max() < 1e-11, np.abs(div).max()
    # and the chain: curl(grad φ) = 0 ⇒ C(G φ) = 0
    h1 = FESpace(mesh, 1)
    from cardiac_ablation_ecm2.ops.vecfe import discrete_gradient

    G = discrete_gradient(h1, nd)
    phi = jnp.asarray(rng.random(h1.ndof_scalar))
    cg_ = np.asarray(C(G(phi)))
    assert np.abs(cg_).max() < 1e-11


def test_matrix_coefficient_curlcurl():
    """Matrix reluctivity in the curl-curl term (CurlCurlIntegrator with
    MatrixCoefficient, fem/bilininteg.hpp:2808): manufactured solution
    E = (sin(pi y) sin(pi z), 0, 0), M = diag(m1, m2, m3) gives
    curl(M curl E) + E = ((m2+m3) pi^2 + 1) E — solve and check the L2
    error drops under refinement; scalar path recovered when M = c I."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem.fe_vector import NDSpace
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.ops.vecfe import (
        build_nd_operator,
        vecfe_linear_form,
    )

    M = np.diag([1.0, 2.0, 4.0])

    def E(x):
        x = np.asarray(x)
        s = np.sin(np.pi * x[..., 1]) * np.sin(np.pi * x[..., 2])
        return np.stack([s, np.zeros_like(s), np.zeros_like(s)], axis=-1)

    def f(x):
        return ((M[1, 1] + M[2, 2]) * np.pi ** 2 + 1.0) * E(x)

    def solve(n):
        mesh = make_cartesian_3d(n, n, n)
        nd = NDSpace(mesh)
        op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=M)
        b = vecfe_linear_form(op, f)
        ess = nd.essential_dofs(None)
        mask = np.ones(nd.ndof)
        mask[ess] = 0.0
        m = jnp.asarray(mask)
        A = lambda v: op.mult(v * m) * m + v * (1 - m)
        x, info = cg(A, b * m, M=lambda r: r / (op.diagonal() * m + (1 - m)),
                     rel_tol=1e-10, max_iter=4000)
        assert bool(info.converged)
        _, _, Bq = next(t for t in op.terms if t[0] == "mass")
        e = (x[op.gather] * op.signs)
        vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
        ex = E(np.asarray(op.gf.x))
        w = np.asarray(op.gf.wdet)
        return float(np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2)))

    e4, e8 = solve(4), solve(8)
    assert e8 < 0.6 * e4, (e4, e8)

    # scalar path equivalence: M = 2I == scalar 2.0
    mesh = make_cartesian_3d(3, 3, 3)
    nd = NDSpace(mesh)
    op_m = build_nd_operator(nd, mass_coeff=1.0,
                             curlcurl_coeff=2.0 * np.eye(3))
    op_s = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=2.0)
    v = jnp.asarray(np.random.default_rng(0).standard_normal(nd.ndof))
    assert float(jnp.abs(op_m.mult(v) - op_s.mult(v)).max()) < 1e-12
