"""Parallel uniform refinement + device-local transfer vs serial HTransfer
(ParMesh::UniformRefinement + ParGridFunction::Update analog)."""

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
from cardiac_ablation_ecm2.fem.transfer import HTransfer
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.parallel import pfespace
from cardiac_ablation_ecm2.parallel.refine import refine_uniform


@pytest.mark.parametrize("dim,order,ndev", [(2, 2, 8), (3, 1, 8), (2, 3, 5)])
def test_parallel_prolongation_matches_serial(dim, order, ndev):
    mesh = make_cartesian_2d(4, 4) if dim == 2 else make_cartesian_3d(2, 2, 2)
    fes_c = FESpace(mesh, order)
    pf = pfespace.build(fes_c, ndev)
    pf_f, pt = refine_uniform(pf)

    # children pinned to the parent's device
    ne_c = mesh.ne
    nchild = pf_f.fes.mesh.ne // ne_c
    for o in range(nchild):
        assert np.array_equal(pf_f.parts[o * ne_c:(o + 1) * ne_c], pf.parts)

    rng = np.random.default_rng(dim * 10 + order)
    uc = rng.standard_normal(fes_c.ndof_scalar)
    ht = HTransfer(fes_c, pf_f.fes)
    uf_serial = np.asarray(ht.prolongate(jnp.asarray(uc)))

    uc_loc = pfespace.scatter_global(pf, uc)
    dmesh = DeviceMesh(np.array(jax.devices("cpu")[:ndev]), ("d",))

    @partial(shard_map, mesh=dmesh, in_specs=(P("d"),) * 7,
             out_specs=P("d"), check_vma=False)
    def go(ucl, gc, cs, gf, pm, sg, sd):
        args = (gc[0], cs[0], gf[0], pm[0], sg[0], sd[0])
        return pt.prolongate_local(args, ucl[0])[None]

    uf_loc = go(jnp.asarray(uc_loc), jnp.asarray(pf.gather), pt.child_slot,
                jnp.asarray(pf_f.gather), jnp.asarray(pf_f.scat_perm),
                jnp.asarray(pf_f.scat_seg), jnp.asarray(pf_f.send_idx))
    uf_par = pfespace.gather_global(pf_f, np.asarray(uf_loc))
    err = np.abs(uf_par[: pf_f.ndof_global] - uf_serial).max()
    assert err < 1e-12, err
