"""Mesh trimmer (miniapps/meshing/trimmer.cpp): remove elements by
attribute; cut faces get bdr_max + trimmed-attribute numbering."""

import numpy as np

from cardiac_ablation_ecm2.fem import FESpace, geom_factors_for
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.mesh.trim import trim


def _two_attr(mesh, axis=0, split=0.5):
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    attrs = np.where(cent[:, axis] < split, 1, 2)
    return Mesh(geom=mesh.geom, vertices=mesh.vertices,
                elements=mesh.elements, attributes=attrs,
                boundary=mesh.boundary, bdr_attributes=mesh.bdr_attributes)


def _volume(mesh):
    fes = FESpace(mesh, 1)
    gf = geom_factors_for(fes)
    return float(np.asarray(gf.wdet).sum())


def test_trim_2d_attributes_and_volume():
    mesh = _two_attr(make_cartesian_2d(4, 4))
    out = trim(mesh, [2])
    assert set(out.attributes) == {1}
    assert abs(_volume(out) - 0.5) < 1e-12
    # cut faces: bdr_max (4) + trimmed attr (2) = 6; outer attrs kept
    assert 6 in set(out.bdr_attributes)
    assert (out.bdr_attributes == 6).sum() == 4        # 4 interface edges
    assert {1, 3, 4}.issubset(set(out.bdr_attributes))
    assert 2 not in set(out.bdr_attributes)            # right side trimmed


def test_trim_custom_map_and_3d():
    mesh = _two_attr(make_cartesian_3d(4, 2, 2), axis=0)
    out = trim(mesh, [1], bdr_attr_map={1: 99})
    assert set(out.attributes) == {2}
    assert (out.bdr_attributes == 99).sum() == 4       # 2x2 cut faces
    assert abs(_volume(out) - 0.5) < 1e-12
    # trimming nothing returns the mesh unchanged
    assert trim(mesh, [7]) is mesh
