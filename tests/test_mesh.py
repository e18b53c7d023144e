"""Mesh construction and refinement invariants (reference analog:
tests/unit/mesh/)."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.mesh import (
    Mesh,
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
    unique_edges,
    unique_faces,
)
from cardiac_ablation_ecm2.fem import FESpace, geom_factors_for


def total_volume(mesh, order=1):
    fes = FESpace(mesh, order)
    gf = geom_factors_for(fes)
    return float(np.sum(np.asarray(gf.wdet)))


def test_cartesian_2d_counts():
    m = make_cartesian_2d(3, 4, 2.0, 1.0)
    assert m.ne == 12 and m.nv == 20
    assert m.nbe == 2 * (3 + 4)
    assert np.isclose(total_volume(m), 2.0)


def test_cartesian_3d_counts():
    m = make_cartesian_3d(2, 3, 4, 1.0, 2.0, 3.0)
    assert m.ne == 24 and m.nv == 3 * 4 * 5
    assert m.nbe == 2 * (2 * 3 + 3 * 4 + 2 * 4)
    assert np.isclose(total_volume(m), 6.0)
    edges, elem_edge = unique_edges(m)
    assert elem_edge.shape == (24, 12)
    faces, elem_face = unique_faces(m)
    # hex grid: faces = 3 * nx*ny*nz + boundary-ish; count via formula
    nfaces = 3 * (2 * 3 * 4) + 2 * 3 * 4 // 4 * 0 + (3 * 4 + 2 * 4 + 2 * 3)
    assert len(faces) == nfaces


def test_simplex_meshes_volume():
    assert np.isclose(total_volume(make_cartesian_2d_tri(3, 3)), 1.0)
    assert np.isclose(total_volume(make_cartesian_3d_tet(2, 2, 2)), 1.0)


@pytest.mark.parametrize("maker,dim", [(make_cartesian_2d, 2), (make_cartesian_3d, 3)])
def test_uniform_refinement(maker, dim):
    m = maker(2, 2) if dim == 2 else maker(2, 2, 2)
    r = m.uniform_refinement()
    assert r.ne == m.ne * 2**dim
    assert r.nbe == m.nbe * 2 ** (dim - 1)
    assert np.isclose(total_volume(r), total_volume(m))
    # refine twice, still consistent
    r2 = r.uniform_refinement()
    assert np.isclose(total_volume(r2), total_volume(m))


def test_tri_refinement():
    m = make_cartesian_2d_tri(2, 2)
    r = m.uniform_refinement()
    assert r.ne == 4 * m.ne
    assert np.isclose(total_volume(r), 1.0)
