"""Cross-device point interpolation vs the serial findpts path
(FindPointsGSLIB on ParMesh analog, fem/gslib.hpp:122)."""

import jax
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.mesh.point_eval import evaluate_at_points
from cardiac_ablation_ecm2.parallel import pfespace
from cardiac_ablation_ecm2.parallel.pointeval import (
    interpolate_sharded,
    prepare,
)


@pytest.mark.parametrize("dim,order,ndev", [(2, 2, 8), (3, 2, 8), (2, 3, 4)])
def test_sharded_matches_serial(dim, order, ndev):
    mesh = make_cartesian_2d(4, 4) if dim == 2 else make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, order)
    pf = pfespace.build(fes, ndev)

    def f(x):
        x = np.asarray(x)
        return np.sin(2 * x[..., 0]) + x[..., 1] ** order

    u = np.asarray(project(fes, f))
    rng = np.random.default_rng(dim)
    pts = rng.uniform(0.05, 0.95, size=(40, dim))

    pe = prepare(pf, pts)
    assert pe.found.all()
    vals = interpolate_sharded(pe, u, devices=jax.devices("cpu"))
    ref = evaluate_at_points(fes, u, pts)
    assert np.allclose(vals, ref, atol=1e-12), np.abs(vals - ref).max()
    # interpolation is exact at this order for the polynomial part and
    # accurate for the smooth part
    assert np.abs(vals - f(pts)).max() < 1e-2


def test_points_outside_mesh_are_zero():
    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2)
    pf = pfespace.build(fes, 8)
    u = np.asarray(project(fes, lambda x: 1.0 + 0 * np.asarray(x)[..., 0]))
    pts = np.array([[0.5, 0.5], [2.5, 0.5], [-1.0, 0.2]])
    pe = prepare(pf, pts)
    assert pe.found.tolist() == [True, False, False]
    vals = interpolate_sharded(pe, u, devices=jax.devices("cpu"))
    assert np.allclose(vals, [1.0, 0.0, 0.0], atol=1e-12)
