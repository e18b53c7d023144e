"""ND0/RT0 on simplices (Whitney elements): constant-field reproduction,
de Rham identities, flux exactness, and ex3/ex4-style solves on tet meshes
with randomly permuted vertex numbering (VERDICT r1 item 6; reference:
ND_TetrahedronElement fem/fe/fe_nd.cpp, RT_TetrahedronElement fe_rt.cpp —
at lowest order every orientation is a sign, folded into the restriction)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.fe_vector import NDSpace, RTSpace
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_2d_tri,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    discrete_gradient,
    vecfe_linear_form,
)
from test_fespace import permute_vertices, perturb


def tet_mesh():
    return perturb(
        permute_vertices(make_cartesian_3d_tet(2, 2, 2), 5), amount=0.08)


def tri_mesh():
    return perturb(
        permute_vertices(make_cartesian_2d_tri(3, 3), 4), amount=0.08)


@pytest.mark.parametrize("mesh_fn", [tri_mesh, tet_mesh])
def test_nd_constant_field_simplex(mesh_fn):
    mesh = mesh_fn()
    sp = NDSpace(mesh)
    M = build_nd_operator(sp, mass_coeff=1.0)
    CC = build_nd_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)
    c = np.array([1.0, -0.5, 0.25][: mesh.dim])
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    diag = M.diagonal()
    u, info = cg(M.mult, b, M=lambda r: r / diag, rel_tol=1e-13,
                 max_iter=3000)
    assert bool(info.converged)
    energy = float(jnp.vdot(u, M.mult(u)))
    vol = float(jnp.sum(M.gf.wdet))
    assert np.isclose(energy, np.dot(c, c) * vol, rtol=1e-9)
    assert abs(float(jnp.vdot(u, CC.mult(u)))) < 1e-9


@pytest.mark.parametrize("mesh_fn", [tri_mesh, tet_mesh])
def test_curl_grad_zero_simplex(mesh_fn):
    mesh = mesh_fn()
    sp = NDSpace(mesh)
    h1 = FESpace(mesh, 1)
    G = discrete_gradient(h1, sp)
    CC = build_nd_operator(sp, mass_coeff=None, curlcurl_coeff=1.0)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(h1.ndof))
    gu = G(u)
    assert float(jnp.abs(CC.mult(gu)).max()) < 1e-10


@pytest.mark.parametrize("mesh_fn", [tri_mesh, tet_mesh])
def test_rt_constant_field_simplex(mesh_fn):
    """Project u = c via RT0 mass; energy = |c|²|Ω| (exact: affine maps),
    div energy = 0."""
    mesh = mesh_fn()
    sp = RTSpace(mesh)
    M = build_rt_operator(sp, mass_coeff=1.0)
    DD = build_rt_operator(sp, mass_coeff=None, divdiv_coeff=1.0)
    c = np.array([0.3, 0.7, -0.2][: mesh.dim])
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    diag = M.diagonal()
    u, info = cg(M.mult, b, M=lambda r: r / diag, rel_tol=1e-13,
                 max_iter=3000)
    assert bool(info.converged)
    energy = float(jnp.vdot(u, M.mult(u)))
    vol = float(jnp.sum(M.gf.wdet))
    assert np.isclose(energy, np.dot(c, c) * vol, rtol=1e-9)
    assert abs(float(jnp.vdot(u, DD.mult(u)))) < 1e-9


def test_beam_tet_reference_mesh():
    """The reference's beam-tet.mesh solves an ND mass system and reproduces
    a constant field (cross-check on an externally authored tet mesh)."""
    mesh = read_mfem_mesh("/root/reference/data/beam-tet.mesh")
    sp = NDSpace(mesh)
    M = build_nd_operator(sp, mass_coeff=1.0)
    c = np.array([0.4, 1.0, -0.3])
    b = vecfe_linear_form(M, lambda x: np.broadcast_to(c, x.shape))
    diag = M.diagonal()
    u, info = cg(M.mult, b, M=lambda r: r / diag, rel_tol=1e-13,
                 max_iter=3000)
    energy = float(jnp.vdot(u, M.mult(u)))
    vol = float(jnp.sum(M.gf.wdet))
    assert np.isclose(energy, np.dot(c, c) * vol, rtol=1e-9)


def test_nd_maxwell_solve_tet():
    """ex3-class: (curl E, curl F) + (E, F) = (f, F) with f = (1,1,1) on a
    tet mesh; SPD system solves and the solution has bounded energy."""
    mesh = tet_mesh()
    sp = NDSpace(mesh)
    A = build_nd_operator(sp, mass_coeff=1.0, curlcurl_coeff=1.0)
    b = vecfe_linear_form(A, lambda x: np.ones(x.shape))
    diag = A.diagonal()
    u, info = cg(A.mult, b, M=lambda r: r / diag, rel_tol=1e-11,
                 max_iter=3000)
    assert bool(info.converged)
    assert np.isfinite(np.asarray(u)).all()


def test_de_rham_complex_tet():
    """Full de Rham chain on tets: curl(grad)=0, div(curl)=0, and the
    divergence of an RT0 interpolant of a linear field is exact."""
    from cardiac_ablation_ecm2.ops.vecfe import (
        discrete_curl,
        discrete_divergence,
    )

    mesh = tet_mesh()
    h1 = FESpace(mesh, 1)
    nd = NDSpace(mesh)
    rt = RTSpace(mesh)
    G = discrete_gradient(h1, nd)
    C = discrete_curl(nd, rt)
    D = discrete_divergence(rt)

    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal(h1.ndof))
    assert float(jnp.abs(C(G(u))).max()) < 1e-12          # curl grad = 0
    E = jnp.asarray(rng.standard_normal(nd.ndof))
    assert float(jnp.abs(D(C(E))).max()) < 1e-10          # div curl = 0


def test_discrete_div_exact_linear_field():
    """u = (x, 2y, 3z) has div = 6 exactly; interpolate into RT0 via face
    fluxes and check D u = 6 on every element."""
    from cardiac_ablation_ecm2.mesh.mesh import unique_faces
    from cardiac_ablation_ecm2.ops.vecfe import discrete_divergence

    mesh = tet_mesh()
    rt = RTSpace(mesh)
    # face dof = flux of u through the face along its canonical normal:
    # for affine faces with linear u, exact by one-point centroid quadrature
    # only for constant u; use exact integration for linear u: flux =
    # area * u(centroid) . n  (midpoint rule is exact for linear integrands)
    faces, _ = unique_faces(mesh)
    V = mesh.vertices
    tri = V[faces]                                   # (nf, 3, 3) sorted tri
    cent = tri.mean(axis=1)
    n_vec = 0.5 * np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    u_c = np.stack([cent[:, 0], 2 * cent[:, 1], 3 * cent[:, 2]], axis=1)
    dofs = jnp.asarray(np.einsum("fd,fd->f", u_c, n_vec))
    D = discrete_divergence(rt)
    div = np.asarray(D(dofs))
    assert np.allclose(div, 6.0, atol=1e-9), (div.min(), div.max())
