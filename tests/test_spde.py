"""Matérn random-field sampling via the fractional SPDE
(models/spde.py; reference miniapps/spde/)."""

import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models.spde import (
    matern_normalization,
    sample_matern_field,
)


def test_matern_marginal_variance():
    """η is calibrated so the marginal std is 1; check the Monte-Carlo std
    at the domain center (ν=1, d=2 ⇒ α=1, one integer solve — fast)."""
    mesh = make_cartesian_2d(16, 16)
    fes = FESpace(mesh, 1)
    n = 160
    U = np.asarray(sample_matern_field(fes, 3, nu=1.0, ell=0.1, num=n))
    X = np.asarray(fes.dof_coords)
    ctr = int(np.argmin(((X - 0.5) ** 2).sum(axis=1)))
    s = U[:, ctr].std()
    # MC std error of std ≈ 1/sqrt(2n) ≈ 5.6%; allow 4σ + discretization
    assert 0.75 < s < 1.25
    assert abs(U[:, ctr].mean()) < 4 * s / np.sqrt(n)


def test_matern_fractional_alpha():
    """Non-integer α path (ν=0.5, d=2 ⇒ α=0.75): the sinc-quadrature
    fractional part runs and produces plausible marginal scale."""
    mesh = make_cartesian_2d(12, 12)
    fes = FESpace(mesh, 1)
    U = np.asarray(sample_matern_field(fes, 1, nu=0.5, ell=0.15, num=60))
    X = np.asarray(fes.dof_coords)
    ctr = int(np.argmin(((X - 0.5) ** 2).sum(axis=1)))
    s = U[:, ctr].std()
    assert 0.6 < s < 1.4


def test_normalization_formula():
    """η² = (2π)^{d/2} ℓ^d Γ(ν + d/2) / (ν^{d/2} Γ(ν)) — spot values."""
    import math

    got = matern_normalization(1.0, 0.2, 2) ** 2
    want = (2 * math.pi) * 0.2 ** 2 * math.gamma(2.0) / (1.0 * math.gamma(1.0))
    assert np.isclose(got, want, rtol=1e-12)
