"""Bernstein control-point bounds of HO fields (fem/bounds.cpp PLBound
analog)."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.bounds import element_bounds
from cardiac_ablation_ecm2.fem.build import basis_for, restriction_for
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d

import jax.numpy as jnp


def _dense_range(fes, u, nq1d=8):
    """Sampled per-element min/max at a dense quadrature grid."""
    db = basis_for(fes, nq1d)
    vals = eval_values(db, restriction_for(fes).mult(jnp.asarray(u)))
    return np.asarray(vals).min(axis=1), np.asarray(vals).max(axis=1)


@pytest.mark.parametrize("p,dim", [(2, 2), (4, 2), (3, 3)])
def test_bounds_contain_true_range(p, dim):
    mesh = make_cartesian_2d(3, 3) if dim == 2 else make_cartesian_3d(2, 2, 2)
    fes = FESpace(mesh, p)
    u = project(fes, lambda x: np.sin(3 * np.asarray(x)[..., 0])
                * np.cos(2 * np.asarray(x)[..., 1]))
    lo, hi = element_bounds(fes, u)
    smin, smax = _dense_range(fes, u)
    assert np.all(lo <= smin + 1e-12)
    assert np.all(hi >= smax - 1e-12)


def test_linear_bounds_are_sharp():
    """For a (bi)linear field the Bernstein net is the field's corner
    values — bounds equal the true element range."""
    fes = FESpace(make_cartesian_2d(4, 4), 1)
    u = project(fes, lambda x: np.asarray(x)[..., 0]
                - 2 * np.asarray(x)[..., 1])
    lo, hi = element_bounds(fes, u)
    # p=1 dofs are the element corners — the true extrema of a linear field
    e = np.asarray(restriction_for(fes).mult(jnp.asarray(u)))
    assert np.allclose(lo, e.min(axis=1), atol=1e-12)
    assert np.allclose(hi, e.max(axis=1), atol=1e-12)


def test_subdivision_tightens():
    fes = FESpace(make_cartesian_2d(2, 2), 4)
    u = project(fes, lambda x: np.sin(4 * np.asarray(x)[..., 0])
                * np.asarray(x)[..., 1] ** 2)
    lo0, hi0 = element_bounds(fes, u, nsub=0)
    lo2, hi2 = element_bounds(fes, u, nsub=2)
    smin, smax = _dense_range(fes, u)
    # still valid bounds …
    assert np.all(lo2 <= smin + 1e-12) and np.all(hi2 >= smax - 1e-12)
    # … and strictly tighter in aggregate
    w0 = (hi0 - lo0).sum()
    w2 = (hi2 - lo2).sum()
    assert w2 < w0 - 1e-10, (w0, w2)
    # subdivided nets converge toward the sampled range
    assert (hi2 - lo2).max() <= (smax - smin).max() + 0.1
