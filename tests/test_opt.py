"""SLBQP (bound + single linear constraint QP) and NNLS active-set solver
(linalg/solvers.hpp:1306, linalg/nnls.hpp:27 analogs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.linalg.opt import nnls, slbqp


def test_slbqp_projects_onto_constraint():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal(50))
    x, iters = slbqp(w, 0.0, 1.0, 10.0)
    x = np.asarray(x)
    assert np.all(x >= -1e-12) and np.all(x <= 1 + 1e-12)
    assert abs(x.sum() - 10.0) < 1e-9
    # KKT: free entries are shifted by a single common multiplier λ
    free = (x > 1e-8) & (x < 1 - 1e-8)
    lam = x[free] - np.asarray(w)[free]
    assert lam.std() < 1e-8


def test_slbqp_weighted_mass_conservation():
    """Conservative limiting use case: keep cell averages bounded while
    conserving total weighted mass."""
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.uniform(-0.4, 1.4, 80))       # overshooting field
    vol = jnp.asarray(rng.uniform(0.5, 2.0, 80))      # cell volumes
    mass = float(jnp.sum(vol * jnp.clip(w, 0, 1))) + 0.3
    x, _ = slbqp(w, 0.0, 1.0, mass, weights=vol)
    assert abs(float(jnp.sum(vol * x)) - mass) < 1e-9
    assert float(jnp.min(x)) >= -1e-12
    assert float(jnp.max(x)) <= 1 + 1e-12


def test_slbqp_interior_solution():
    """Unconstrained-feasible case reduces to the plain shift."""
    w = jnp.asarray([0.2, 0.4, 0.6])
    x, _ = slbqp(w, 0.0, 1.0, 1.5)
    # Σ(w + λ) = 1.5 ⇒ λ = 0.1
    assert np.allclose(np.asarray(x), [0.3, 0.5, 0.7], atol=1e-9)


@pytest.mark.parametrize("m,n,seed", [(20, 10, 0), (30, 30, 1), (15, 25, 2)])
def test_nnls_matches_scipy(m, n, seed):
    from scipy.optimize import nnls as scipy_nnls

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x = nnls(A, b)
    x_ref, r_ref = scipy_nnls(A, b)
    assert np.all(x >= 0)
    r = np.linalg.norm(A @ x - b)
    assert r <= r_ref + 1e-8, (r, r_ref)


def test_nnls_exact_nonnegative_solution():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 12))
    x0 = np.abs(rng.standard_normal(12))
    x = nnls(A, A @ x0)
    assert np.allclose(x, x0, atol=1e-8)
