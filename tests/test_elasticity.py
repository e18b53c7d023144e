"""Elasticity: PA-vs-FULL cross-check, boundary (Robin) mass integrator, and
the ex2 cantilever."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.models import elasticity as ela
from cardiac_ablation_ecm2.ops import BilinearForm
from test_fespace import permute_vertices, perturb


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [1, 2])
def test_elasticity_pa_matches_full(dim, p):
    mesh = make_cartesian_2d(3, 2) if dim == 2 else make_cartesian_3d(2, 2, 2)
    mesh = perturb(permute_vertices(mesh, 1), amount=0.1)
    fes = FESpace(mesh, p, vdim=dim)

    def lam(x):
        return 1.0 + 0.3 * np.asarray(x[..., 0])

    def mu(x):
        return 0.5 + 0.2 * np.asarray(x[..., 1])

    a = BilinearForm(fes).add_domain_integrator("elasticity", coeff=(lam, mu))
    A_pa = a.assemble()
    A_full = a.assemble_matrix()
    rng = np.random.default_rng(0)
    x = rng.random(fes.ndof)
    y_pa = np.asarray(A_pa.mult(jnp.asarray(x)))
    y_full = A_full @ x
    assert np.allclose(y_pa, y_full, atol=1e-11 * max(np.abs(y_full).max(), 1)), (
        np.abs(y_pa - y_full).max()
    )
    d_pa = np.asarray(A_pa.diagonal())
    assert np.allclose(d_pa, A_full.diagonal(), atol=1e-11), (
        np.abs(d_pa - A_full.diagonal()).max()
    )
    # symmetry + positive semidefiniteness spot checks
    y2 = rng.random(fes.ndof)
    assert np.isclose(y2 @ (A_full @ x), x @ (A_full @ y2))
    assert x @ (A_full @ x) >= -1e-12


def test_boundary_mass_pa_matches_full():
    """Robin-term boundary mass (σu, v)_∂Ω cross-check."""
    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2)
    a = (
        BilinearForm(fes)
        .add_domain_integrator("diffusion")
        .add_boundary_integrator("mass", coeff=2.5, marker=[1, 3])
    )
    A_pa = a.assemble()
    A_full = a.assemble_matrix()
    rng = np.random.default_rng(1)
    x = rng.random(fes.ndof)
    y_pa = np.asarray(A_pa.mult(jnp.asarray(x)))
    assert np.allclose(y_pa, A_full @ x, atol=1e-11)
    assert np.allclose(np.asarray(A_pa.diagonal()), A_full.diagonal(), atol=1e-11)


def test_ex2_cantilever_beam():
    """ex2 on the reference beam-quad mesh: fixed left end, pull on attr 2."""
    mesh = read_mfem_mesh("/root/reference/data/beam-quad.mesh")
    res = ela.solve(mesh, order=1, lam=1.0, mu=1.0, rel_tol=1e-10)
    assert res.converged
    d = res.displacement()
    # fixed end stays put
    ess = res.fes.essential_dofs([1])
    assert np.allclose(d[ess], 0.0)
    # beam bends downward, tip moves most
    assert d[:, 1].min() < -1e-3
    x = res.fes.dof_coords
    tip = np.argmax(x[:, 0])
    assert d[tip, 1] < 0.5 * d[:, 1].min() * 0 + d[:, 1].min() * 0.5
    # monotone-ish: displacement magnitude grows along the beam
    left = np.abs(d[x[:, 0] < 2.0, 1]).max()
    right = np.abs(d[x[:, 0] > 6.0, 1]).max()
    assert right > left


def test_robin_poisson_solution():
    """-Δu = 1 with Robin BC u + du/dn = 0 on all sides: compare against
    dense direct solve of the FULL matrix."""
    import scipy.sparse.linalg as spla

    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 2)
    a = (
        BilinearForm(fes)
        .add_domain_integrator("diffusion")
        .add_boundary_integrator("mass", coeff=1.0)
    )
    from cardiac_ablation_ecm2.ops.linearform import domain_lf
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.linalg.smoothers import jacobi

    A_pa = a.assemble()
    b = domain_lf(fes, None)
    x, info = cg(A_pa.mult, b, M=jacobi(A_pa.diagonal()), rel_tol=1e-13,
                 max_iter=500)
    assert info.converged
    A_full = a.assemble_matrix()
    x_ref = spla.spsolve(A_full.tocsc(), np.asarray(b))
    assert np.allclose(np.asarray(x), x_ref, atol=1e-9)
