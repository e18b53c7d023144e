"""Obstacle problem (ex36 analog): PDAS semismooth Newton, KKT-verified."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.obstacle import obstacle_solve
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def _setup(n=12):
    mesh = make_cartesian_2d(n, n)
    fes = FESpace(mesh, 1)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    b = domain_lf(fes, lambda x: -8.0 + 0 * np.asarray(x)[..., 0])
    ess = fes.essential_dofs()
    fm = jnp.zeros(fes.ndof_scalar).at[jnp.asarray(ess)].set(1.0)
    psi = jnp.full(fes.ndof_scalar, -0.08)
    return fes, A, b, psi, fm


def test_kkt_conditions():
    """Membrane pressed onto a flat obstacle: feasibility, nonnegative
    multiplier, complementarity, and interior stationarity."""
    fes, A, b, psi, fm = _setup()
    u, lam, outer = obstacle_solve(A.mult, b, psi, diag=A.diagonal(),
                                   fixed_mask=fm)
    u_np, lam_np = np.asarray(u), np.asarray(lam)
    assert outer < 40
    assert np.all(u_np >= np.asarray(psi) - 1e-10)      # feasible
    contact = lam_np > 1e-10
    assert contact.any(), "load should produce a contact region"
    # complementarity: λ > 0 only where u == ψ
    assert np.allclose(u_np[contact], -0.08, atol=1e-9)
    # interior stationarity: residual vanishes off the contact/fixed sets
    r = np.asarray(A.mult(u) - b)
    inactive = (~contact) & (np.asarray(fm) == 0)
    assert np.abs(r[inactive]).max() < 1e-8
    # multiplier sign
    assert lam_np.min() > -1e-10


def test_no_contact_reduces_to_linear():
    """A deep obstacle never binds: the solution equals the plain solve."""
    from cardiac_ablation_ecm2.linalg.solvers import cg

    fes, A, b, _psi, fm = _setup(8)
    psi = jnp.full(fes.ndof_scalar, -10.0)
    u, lam, outer = obstacle_solve(A.mult, b, psi, diag=A.diagonal(),
                                   fixed_mask=fm)
    m = 1 - fm
    A_c = lambda v: A.mult(v * m) * m + v * (1 - m)
    u_ref, _ = cg(A_c, b * m, rel_tol=1e-12, max_iter=3000)
    assert np.abs(np.asarray(lam)).max() < 1e-12
    assert np.allclose(np.asarray(u), np.asarray(u_ref), atol=1e-9)


def test_energy_optimality():
    """The PDAS solution minimizes energy over sampled feasible
    perturbations."""
    fes, A, b, psi, fm = _setup(8)
    u, lam, _ = obstacle_solve(A.mult, b, psi, diag=A.diagonal(),
                               fixed_mask=fm)

    def energy(v):
        return 0.5 * float(v @ A.mult(v)) - float(b @ v)

    e0 = energy(u)
    rng = np.random.default_rng(0)
    m = np.asarray(1 - fm)
    for _ in range(5):
        dv = 0.01 * rng.standard_normal(fes.ndof_scalar) * m
        v = jnp.maximum(u + jnp.asarray(dv), psi)      # feasible
        v = v * (1 - fm) + u * fm
        assert energy(v) >= e0 - 1e-10
