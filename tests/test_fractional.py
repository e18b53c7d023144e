"""Spectral fractional Laplacian via sinc-quadrature rational sums
(ex33 analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import l2_error
from cardiac_ablation_ecm2.linalg.fractional import (
    fractional_apply,
    fractional_solve,
)
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def _pencil(n=6, p=1):
    mesh = make_cartesian_2d(n, n)
    fes = FESpace(mesh, p)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    M = BilinearForm(fes).add_domain_integrator("mass").assemble()
    ess = jnp.asarray(fes.essential_dofs())
    m = jnp.ones(fes.ndof_scalar).at[ess].set(0.0)
    Am = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mm = lambda v: M.mult(v * m) * m + v * (1 - m)
    dA = A.diagonal() * m + (1 - m)
    dM = M.diagonal() * m + (1 - m)
    return fes, Am, Mm, dA, dM, m


def test_eigenvector_power_identity():
    """A_M^{-s} x_i = λ_i^{-s} x_i for pencil eigenpairs (dense
    cross-check on a small mesh)."""
    fes, Am, Mm, dA, dM, mask = _pencil(5)
    n = fes.ndof_scalar
    I = np.eye(n)
    Ad = np.stack([np.asarray(Am(jnp.asarray(I[:, j]))) for j in range(n)],
                  axis=1)
    Md = np.stack([np.asarray(Mm(jnp.asarray(I[:, j]))) for j in range(n)],
                  axis=1)
    from scipy.linalg import eigh

    lam, V = eigh(Ad, Md)
    # pick an interior (non-constrained) eigenpair away from the ess λ=1
    sel = np.argsort(np.abs(lam - 1.0))[-1]
    x = jnp.asarray(V[:, sel])
    s = 0.5
    y = fractional_apply(Am, Mm, dA, dM, s, x, lam_min=lam.min(),
                         lam_max=lam.max(), k=0.22)
    ref = lam[sel] ** (-s) * np.asarray(x)
    assert np.allclose(np.asarray(y), ref, atol=5e-5), \
        np.abs(np.asarray(y) - ref).max()


def test_first_mode_solution():
    """(−Δ)^s u = sin πx sin πy ⇒ u = (2π²)^{-s} sin πx sin πy."""
    fes, Am, Mm, dA, dM, mask = _pencil(8, p=2)
    f = lambda x: np.sin(np.pi * np.asarray(x)[..., 0]) * np.sin(
        np.pi * np.asarray(x)[..., 1])
    b = domain_lf(fes, f) * mask
    s = 0.5
    u = fractional_solve(Am, Mm, dA, dM, s, b,
                         lam_min=2 * np.pi ** 2 / 4, lam_max=1e5, k=0.45)
    exact = lambda x: (2 * np.pi ** 2) ** (-s) * f(x)
    assert float(l2_error(fes, u, exact)) < 5e-4
