"""Embedded surface meshes + Laplace–Beltrami (ex7/ex29 analogs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import geom_factors_for
from cardiac_ablation_ecm2.linalg.lobpcg import lobpcg
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.surface import make_sphere_quad
from cardiac_ablation_ecm2.ops.surface import surface_operators


def test_area_convergence():
    """Faceted O(h²), curved order-2 ≈ O(h⁴) sphere area."""
    def area(n, q):
        mesh = make_sphere_quad(n, curved_order=q)
        fes = FESpace(mesh, 2)
        return float(jnp.sum(geom_factors_for(fes).wdet))

    exact = 4 * np.pi
    e_flat = [abs(area(n, 0) - exact) for n in (4, 8)]
    assert np.log2(e_flat[0] / e_flat[1]) > 1.8
    assert abs(area(6, 2) - exact) < 1e-3 * exact


def test_sphere_spectrum():
    """Laplace–Beltrami on the unit sphere: eigenvalues l(l+1) with
    multiplicity 2l+1 — [0, 2,2,2, 6,...]."""
    mesh = make_sphere_quad(6, curved_order=2)
    fes = FESpace(mesh, 2)
    Amult, Adiag = surface_operators(fes, diffusion_coeff=1.0)
    Mmult, _ = surface_operators(fes, mass_coeff=1.0)
    d = jnp.maximum(Adiag(), 1e-12)
    res = lobpcg(Amult, Mmult, fes.ndof_scalar, k=5,
                 precond=lambda r: r / d, iters=80)
    lam = np.sort(np.asarray(res.eigenvalues))
    assert abs(lam[0]) < 1e-7
    assert np.allclose(lam[1:4], 2.0, rtol=2e-3), lam
    assert abs(lam[4] - 6.0) < 0.05, lam


def test_shifted_solve_reproduces_harmonic():
    """(−Δ_S + 1) u = 3·z on the unit sphere ⇒ u = z (Y₁ harmonic)."""
    mesh = make_sphere_quad(6, curved_order=2)
    fes = FESpace(mesh, 2)
    mult, diag = surface_operators(fes, diffusion_coeff=1.0,
                                   mass_coeff=1.0)
    Mmult, _ = surface_operators(fes, mass_coeff=1.0)
    z = jnp.asarray(fes.dof_coords[:, 2])
    b = Mmult(3.0 * z)
    u, info = cg(mult, b, M=lambda r: r / diag(), rel_tol=1e-12,
                 max_iter=3000)
    assert bool(info.converged)
    err = float(jnp.abs(u - z).max())
    assert err < 2e-4, err
