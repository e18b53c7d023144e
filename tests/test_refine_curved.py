"""Uniform refinement of curved (high-order nodes) meshes.

Reference analog: ``mesh/mesh.cpp`` UniformRefinement on curved meshes
updates the nodal GridFunction so children carry the SAME geometry.  Our
children evaluate the parent order-q map at affinely-embedded child lattice
points — exact for any geometry the parent can represent, which these tests
pin two ways:

1. commutation: for a polynomial mapping of degree ≤ q,
   ``refine(curve(mesh)) == curve(refine(mesh))`` node-for-node;
2. volume: the curved volume integral is unchanged by refinement.
"""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace, geom_factors_for
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
)
from cardiac_ablation_ecm2.mesh.mesh import curve_mesh


def quad_map_2d(x):
    x = np.asarray(x)
    u, v = x[..., 0], x[..., 1]
    return np.stack([u + 0.1 * v * v, v + 0.05 * u * u + 0.02 * u * v],
                    axis=-1)


def quad_map_3d(x):
    x = np.asarray(x)
    u, v, w = x[..., 0], x[..., 1], x[..., 2]
    return np.stack(
        [u + 0.1 * v * w, v + 0.05 * u * u, w + 0.03 * u * v],
        axis=-1,
    )


def total_volume(mesh, order=2):
    fes = FESpace(mesh, order)
    gf = geom_factors_for(fes)
    return float(np.sum(np.asarray(gf.wdet)))


@pytest.mark.parametrize("maker,mapping", [
    (lambda: make_cartesian_2d(3, 3), quad_map_2d),
    (lambda: make_cartesian_2d_tri(3, 3), quad_map_2d),
    (lambda: make_cartesian_3d(2, 2, 2), quad_map_3d),
])
def test_refine_commutes_with_curving(maker, mapping):
    straight = maker()
    curved = curve_mesh(straight, mapping, order=2)

    a = curved.uniform_refinement()                          # refine the curved mesh
    b = curve_mesh(straight.uniform_refinement(), mapping, order=2)  # curve the fine

    assert a.nodes_order == 2
    assert a.elements.shape == b.elements.shape
    np.testing.assert_allclose(a.nodes, b.nodes, atol=1e-12)
    np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-12)
    # topology identical to the straight refinement
    np.testing.assert_array_equal(a.elements, b.elements)
    np.testing.assert_array_equal(a.boundary, b.boundary)


def test_refined_volume_exact():
    m = curve_mesh(make_cartesian_2d(4, 4), quad_map_2d, order=2)
    v0 = total_volume(m, order=3)
    v1 = total_volume(m.uniform_refinement(), order=3)
    assert np.isclose(v0, v1, rtol=1e-12)


def test_refined_curved_space_builds():
    m = curve_mesh(make_cartesian_3d(2, 2, 2), quad_map_3d, order=2)
    r = m.uniform_refinement()
    fes = FESpace(r, 2)
    assert fes.ndof_scalar > FESpace(m, 2).ndof_scalar
    # dof coords are single-valued across shared entities (continuity)
    from cardiac_ablation_ecm2.fem.fespace import element_node_coords

    Xe = element_node_coords(r, 2)
    coords = np.zeros((fes.ndof_scalar, 3))
    coords[fes.gather_map.reshape(-1)] = Xe.reshape(-1, 3)
    err = np.abs(coords[fes.gather_map] - Xe).max()
    assert err < 1e-10
