"""Assembly-level cross-checking: PARTIAL (matrix-free) vs FULL (assembled
CSR) operators must agree to tight tolerance across geometries and orders.

This is the port of the reference's single most important correctness harness
(tests/unit/fem/test_assembly_levels.cpp — SURVEY.md §4).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from test_fespace import permute_vertices, perturb

MAKERS = {
    "quad": lambda: make_cartesian_2d(3, 2),
    "hex": lambda: make_cartesian_3d(2, 2, 2),
    "tri": lambda: make_cartesian_2d_tri(2, 3),
    "tet": lambda: make_cartesian_3d_tet(2, 2, 2),
}


def make_mesh(name):
    return perturb(permute_vertices(MAKERS[name](), seed=3), amount=0.1)


@pytest.mark.parametrize("name", list(MAKERS))
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("kind", ["mass", "diffusion"])
def test_pa_matches_full(name, p, kind):
    mesh = make_mesh(name)
    fes = FESpace(mesh, p)

    def coeff(x):
        return 1.0 + 0.5 * np.asarray(x[..., 0]) + 0.25 * np.asarray(x[..., 1]) ** 2

    a = BilinearForm(fes).add_domain_integrator(kind, coeff)
    A_pa = a.assemble()
    A_full = a.assemble_matrix()

    rng = np.random.default_rng(42)
    x = rng.random(fes.ndof_scalar)
    y_pa = np.asarray(A_pa.mult(jnp.asarray(x)))
    y_full = A_full @ x
    scale = np.abs(y_full).max()
    assert np.allclose(y_pa, y_full, atol=1e-11 * max(scale, 1)), (
        name, p, kind, np.abs(y_pa - y_full).max()
    )
    # diagonal cross-check (AssembleDiagonalPA analog)
    d_pa = np.asarray(A_pa.diagonal())
    d_full = A_full.diagonal()
    assert np.allclose(d_pa, d_full, atol=1e-11 * max(np.abs(d_full).max(), 1))


@pytest.mark.parametrize("name", ["quad", "hex", "tet"])
@pytest.mark.parametrize("p", [1, 2])
def test_convection_pa_matches_full(name, p):
    mesh = make_mesh(name)
    fes = FESpace(mesh, p)
    dim = mesh.dim

    def vel(x):
        x = np.asarray(x)
        v = [1.0 + 0.3 * x[..., 0], -0.5 + 0.2 * x[..., 1]]
        if dim == 3:
            v.append(0.7 * np.ones_like(x[..., 0]))
        return np.stack(v, axis=-1)

    a = BilinearForm(fes).add_domain_integrator("convection", vector_coeff=vel)
    A_pa = a.assemble()
    A_full = a.assemble_matrix()
    rng = np.random.default_rng(1)
    x = rng.random(fes.ndof_scalar)
    y_pa = np.asarray(A_pa.mult(jnp.asarray(x)))
    y_full = A_full @ x
    assert np.allclose(y_pa, y_full, atol=1e-11 * max(np.abs(y_full).max(), 1))
    d_pa = np.asarray(A_pa.diagonal())
    assert np.allclose(d_pa, A_full.diagonal(), atol=1e-11)


def test_mass_plus_diffusion_sum():
    mesh = make_mesh("hex")
    fes = FESpace(mesh, 2)
    a = (
        BilinearForm(fes)
        .add_domain_integrator("mass", 2.0)
        .add_domain_integrator("diffusion")
    )
    A_pa = a.assemble()
    A_full = a.assemble_matrix()
    rng = np.random.default_rng(2)
    x = rng.random(fes.ndof_scalar)
    assert np.allclose(np.asarray(A_pa.mult(jnp.asarray(x))), A_full @ x, atol=1e-11)


def test_mass_matrix_total():
    """Σ_ij M_ij = |Ω| — volume consistency of assembled mass matrix."""
    mesh = make_mesh("hex")
    fes = FESpace(mesh, 2)
    M = BilinearForm(fes).add_domain_integrator("mass").assemble_matrix()
    # |Ω| of the perturbed unit cube is still 1 (interior-only perturbation)
    assert np.isclose(M.sum(), 1.0, atol=1e-10)


def test_packed_diffusion_matches_full():
    """Packed symmetric qdata path == full-matrix qdata path."""
    from cardiac_ablation_ecm2.ops import diffusion as dmod
    from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for, restriction_for

    for name in ("quad", "hex"):
        mesh = make_mesh(name)
        fes = FESpace(mesh, 2)
        db = basis_for(fes)
        gf = geom_factors_for(fes)
        R = restriction_for(fes)
        qd = dmod.setup(gf, 1.7)
        qp = dmod.pack_sym(qd)
        rng = np.random.default_rng(0)
        e = jnp.asarray(rng.random((mesh.ne, fes.nd_elem)))
        y1 = np.asarray(dmod.apply(db, qd, e))
        y2 = np.asarray(dmod.apply(db, qp, e))
        assert np.allclose(y1, y2, atol=1e-12)
        d1 = np.asarray(dmod.diagonal(db, qd))
        d2 = np.asarray(dmod.diagonal(db, qp))
        assert np.allclose(d1, d2, atol=1e-12)


def test_setup_packed_matches_pack_sym():
    from cardiac_ablation_ecm2.ops import diffusion as dmod
    from cardiac_ablation_ecm2.fem.build import geom_factors_for

    for name in ("quad", "hex"):
        mesh = make_mesh(name)
        fes = FESpace(mesh, 2)
        gf = geom_factors_for(fes)
        q1 = np.asarray(dmod.pack_sym(dmod.setup(gf, 1.3)))
        q2 = np.asarray(dmod.setup_packed(gf, 1.3))
        assert np.allclose(q1, q2, atol=1e-13)
