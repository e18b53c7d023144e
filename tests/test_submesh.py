"""SubMesh + TransferMap (multidomain.cpp analog)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.mesh.submesh import (
    create_from_boundary,
    create_from_domain,
    create_transfer_map,
)
from cardiac_ablation_ecm2.fem.geometry import Geometry


def two_material_mesh():
    m = make_cartesian_2d(4, 4)
    cent = m.vertices[m.elements].mean(axis=1)
    attrs = np.where(cent[:, 0] < 0.5, 1, 2)
    return Mesh(
        geom=m.geom, vertices=m.vertices, elements=m.elements,
        attributes=attrs, boundary=m.boundary,
        bdr_attributes=m.bdr_attributes,
    )


@pytest.mark.parametrize("p", [1, 2, 3])
def test_domain_submesh_transfer(p):
    parent = two_material_mesh()
    sm = create_from_domain(parent, [1])
    assert sm.mesh.ne == 8
    pfes = FESpace(parent, p)
    sfes = FESpace(sm.mesh, p)
    tm = create_transfer_map(pfes, sfes, sm)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** p + 2.0 * x[..., 1]

    up = project(pfes, f)
    us = tm.to_sub(up)
    us_direct = project(sfes, f)
    assert np.allclose(np.asarray(us), np.asarray(us_direct), atol=1e-12)

    # round trip: write back modified values
    up2 = tm.to_parent(us * 2.0, up)
    assert np.allclose(np.asarray(tm.to_sub(up2)), np.asarray(us) * 2.0)


def test_boundary_submesh_transfer():
    parent = make_cartesian_3d(3, 3, 3)
    sm = create_from_boundary(parent, [6])   # top face z=1
    assert sm.mesh.ne == 9 and sm.mesh.geom == Geometry.SQUARE
    pfes = FESpace(parent, 2)
    sfes = FESpace(sm.mesh, 2)
    tm = create_transfer_map(pfes, sfes, sm)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] * x[..., 1] + x[..., 0] ** 2

    up = project(pfes, f)
    us = tm.to_sub(up)
    # sub dof coords live on z=1; values must match f there
    vals = f(sfes.dof_coords)
    assert np.allclose(np.asarray(us), vals, atol=1e-12)


def test_interface_attribute():
    parent = two_material_mesh()
    sm = create_from_domain(parent, [1])
    # interface faces must carry a fresh boundary attribute
    new_attr = int(parent.bdr_attributes.max()) + 1
    assert (sm.mesh.bdr_attributes == new_attr).sum() == 4  # x=0.5 line
    # and the fresh-attr boundary dofs of the submesh sit on x=0.5
    sfes = FESpace(sm.mesh, 2)
    ess = sfes.essential_dofs([new_attr])
    assert np.allclose(sfes.dof_coords[ess][:, 0], 0.5)
