"""Parallel SubMesh transfer under shard_map vs the serial TransferMap.

Reference analog: ParSubMesh/ParTransferMap (mesh/submesh/psubmesh.hpp:55,
ptransfermap.hpp) as used by miniapps/multidomain.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_3d
from cardiac_ablation_ecm2.mesh.submesh import (
    create_from_boundary,
    create_from_domain,
    create_transfer_map,
)
from cardiac_ablation_ecm2.parallel import pfespace
from cardiac_ablation_ecm2.parallel.psubmesh import (
    build_sub,
    transfer_to_parent,
    transfer_to_sub,
)


def two_material_3d():
    m = make_cartesian_3d(3, 3, 3)
    cent = m.vertices[m.elements].mean(axis=1)
    attrs = np.where(cent[:, 0] < 0.5, 1, 2)
    return Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
                attributes=attrs, boundary=m.boundary,
                bdr_attributes=m.bdr_attributes)


def _run_transfers(parent_pf, sub_pf, pt, up_loc, ndev):
    dmesh = DeviceMesh(np.array(jax.devices("cpu")[:ndev]), ("d",))

    @partial(shard_map, mesh=dmesh, in_specs=(P("d"),) * 4,
             out_specs=(P("d"), P("d")), check_vma=False)
    def go(upl, idx, wm, sd):
        upl, idx, wm, sd = upl[0], idx[0], wm[0], sd[0]
        us = transfer_to_sub(idx, upl)
        up2 = transfer_to_parent(idx, us * 2.0, upl, wmask_d=wm,
                                 send_idx_d=sd, perms=parent_pf.perms,
                                 nloc=parent_pf.nloc)
        return us[None], up2[None]

    return go(jnp.asarray(up_loc), pt.idx, pt.wmask,
              jnp.asarray(parent_pf.send_idx))


@pytest.mark.parametrize("order,ndev", [(1, 4), (2, 8), (3, 8)])
def test_domain_par_transfer(order, ndev):
    parent = two_material_3d()
    sm = create_from_domain(parent, [1])
    pfes = FESpace(parent, order)
    sfes = FESpace(sm.mesh, order)
    parent_pf = pfespace.build(pfes, ndev)
    sub_pf, pt = build_sub(parent_pf, sm, sfes)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** order + 2 * x[..., 1] - x[..., 2]

    up = np.asarray(project(pfes, f))
    up_loc = pfespace.scatter_global(parent_pf, up)
    us_loc, up2_loc = _run_transfers(parent_pf, sub_pf, pt, up_loc, ndev)

    tm = create_transfer_map(pfes, sfes, sm)
    us_serial = np.asarray(tm.to_sub(jnp.asarray(up)))
    us_par = pfespace.gather_global(sub_pf, np.asarray(us_loc))
    assert np.array_equal(us_par[: sfes.ndof_scalar], us_serial)

    up2_serial = np.asarray(
        tm.to_parent(jnp.asarray(us_serial) * 2.0, jnp.asarray(up)))
    up2_par = pfespace.gather_global(parent_pf, np.asarray(up2_loc))
    assert np.array_equal(up2_par[: pfes.ndof_scalar], up2_serial)


def test_boundary_par_transfer():
    parent = make_cartesian_3d(3, 3, 3)
    sm = create_from_boundary(parent, [6])        # z=1 face sheet
    pfes = FESpace(parent, 2)
    sfes = FESpace(sm.mesh, 2)
    parent_pf = pfespace.build(pfes, 8)
    sub_pf, pt = build_sub(parent_pf, sm, sfes)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] * x[..., 1] + x[..., 0] ** 2

    up = np.asarray(project(pfes, f))
    up_loc = pfespace.scatter_global(parent_pf, up)
    us_loc, _ = _run_transfers(parent_pf, sub_pf, pt, up_loc, 8)
    us_par = pfespace.gather_global(sub_pf, np.asarray(us_loc))
    vals = f(sfes.dof_coords)
    assert np.allclose(us_par[: sfes.ndof_scalar], vals, atol=1e-12)


def test_inherited_partition_is_consistent():
    """Every sub element is assigned to its parent element's device."""
    from cardiac_ablation_ecm2.parallel.psubmesh import sub_partition

    parent = two_material_3d()
    sm = create_from_domain(parent, [2])
    pfes = FESpace(parent, 1)
    parent_pf = pfespace.build(pfes, 8)
    parts = sub_partition(parent_pf.parts, sm)
    assert np.array_equal(parts, parent_pf.parts[sm.parent_elems])
