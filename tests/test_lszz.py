"""LSZZ patch-recovery estimator (LSZienkiewiczZhuEstimator,
fem/estimators.hpp:241)."""

import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.estimators import (
    lszz_estimator,
    zz_estimator,
)
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d


def test_affine_exact():
    """Affine fields have constant gradient — patch LS recovery reproduces
    it exactly, so η ≈ 0 (the P1-exactness property of LSZZ)."""
    for mesh, p in [(make_cartesian_2d(4, 4), 1),
                    (make_cartesian_3d(2, 2, 2), 2)]:
        fes = FESpace(mesh, p)
        u = project(fes, lambda x: 2 * np.asarray(x)[..., 0]
                    - 3 * np.asarray(x)[..., 1] + 0.5)
        eta = lszz_estimator(fes, u)
        assert eta.max() < 1e-9, eta.max()


def test_symmetry_uniform_field():
    """x²+y² on a uniform mesh: every element gets the same estimate."""
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 1)
    u = project(fes, lambda x: np.sum(np.asarray(x) ** 2, axis=-1))
    eta = lszz_estimator(fes, u)
    assert eta.std() < 1e-8 * eta.mean()


def test_estimates_shrink_under_refinement():
    def total(n):
        mesh = make_cartesian_2d(n, n)
        fes = FESpace(mesh, 1)
        u = project(fes, lambda x: np.sin(
            np.pi * np.asarray(x)[..., 0]) * np.asarray(x)[..., 1])
        return np.sqrt((lszz_estimator(fes, u) ** 2).sum())

    e4, e8 = total(4), total(8)
    assert e8 < 0.6 * e4, (e4, e8)


def test_marks_singular_corner():
    """On the L-shape singular solution the corner elements dominate —
    the same marking behavior as the plain ZZ estimator."""
    from tests.test_amr import lshape_mesh, u_singular

    mesh = lshape_mesh()
    fes = FESpace(mesh, 2)
    u = project(fes, u_singular)
    eta = lszz_estimator(fes, u)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    r = np.linalg.norm(cent, axis=1)
    # the element(s) nearest the re-entrant corner carry the top estimate
    assert r[np.argmax(eta)] < np.median(r)
