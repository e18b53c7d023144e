"""Hyperelasticity via energy + jax.grad (ex10 analog)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, Mesh
from cardiac_ablation_ecm2.models import elasticity as lin_ela
from cardiac_ablation_ecm2.models.hyperelastic import (
    HyperelasticProblem,
    neo_hookean_W,
)


def beam_mesh():
    m = make_cartesian_2d(8, 2, 4.0, 1.0)
    return m


def test_energy_zero_at_identity():
    F = jnp.eye(2)[None, None]
    W = neo_hookean_W(F, 1.0, 10.0)
    assert abs(float(W[0, 0])) < 1e-14


def test_small_strain_matches_linear_elasticity():
    """Tiny load ⇒ neo-Hookean ≈ linear elasticity with λ = κ − 2μ/d."""
    mesh = beam_mesh()
    dim = 2
    mu, kappa = 1.0, 10.0
    tiny = np.array([0.0, -1e-4])
    fes = FESpace(mesh, 1, vdim=dim)
    prob = HyperelasticProblem(
        fes=fes, mu=mu, kappa=kappa, fixed_bdr=[4], force_bdr=[2], force=tiny,
    )
    u, info = prob.solve(rel_tol=1e-10)
    assert bool(info.converged), int(info.iterations)
    d_nl = prob.displacement(u)

    # NOTE linearization of this compressible NH at identity: σ = μ(∇u+∇uᵀ)
    # − (2μ/d)(∇·u)I + κ(∇·u)I ⇒ λ_eff = κ − 2μ/d
    lam_eff = kappa - 2 * mu / dim
    res_lin = lin_ela.solve(
        mesh, order=1, lam=lam_eff, mu=mu, fixed_bdr=[4], force_bdr=[2],
        force=tiny, rel_tol=1e-12,
    )
    d_lin = res_lin.displacement()
    scale = np.abs(d_lin).max()
    assert scale > 1e-7
    rel = np.abs(d_nl - d_lin).max() / scale
    assert rel < 5e-3, rel


def test_large_deflection_finite_and_monotone():
    """Ramp the load: deflection grows monotonically and stays finite with
    J > 0 (no element inversion)."""
    mesh = beam_mesh()
    fes = FESpace(mesh, 1, vdim=2)
    prev = 0.0
    for mag in (0.001, 0.003):
        prob = HyperelasticProblem(
            fes=fes, mu=1.0, kappa=10.0, fixed_bdr=[4], force_bdr=[2],
            force=np.array([0.0, -mag]),
        )
        u, info = prob.solve()
        assert bool(info.converged)
        tip = np.abs(prob.displacement(u)[:, 1]).max()
        assert np.isfinite(tip) and tip > prev
        prev = tip
        F = prob.deformation_gradient(u)
        J = np.asarray(jnp.linalg.det(F))
        assert J.min() > 0.1, J.min()
