"""Repartitioning: weighted RCB balance + old→new field transfer fidelity."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.parallel import pfespace
from cardiac_ablation_ecm2.parallel.partition import (
    element_centroids,
    rcb_weighted,
)
from cardiac_ablation_ecm2.parallel.rebalance import (
    repartition,
    transfer_map,
)


def test_weighted_rcb_balances_load():
    mesh = make_cartesian_2d(8, 8)
    cent = element_centroids(mesh)
    # quadratic cost gradient: left half 10x the cost of the right half
    w = np.where(cent[:, 0] < 0.5, 10.0, 1.0)
    parts = rcb_weighted(cent, w, 4)
    loads = np.array([w[parts == d].sum() for d in range(4)])
    assert loads.max() / loads.min() < 1.6     # vs 10x for equal-count RCB
    counts = np.bincount(parts, minlength=4)
    assert (counts > 0).all()


def test_transfer_field_exact():
    mesh = make_cartesian_3d(4, 4, 4)
    fes = FESpace(mesh, 2)
    pf_old = pfespace.build(fes, 4)

    w = np.linspace(1.0, 5.0, mesh.ne)           # skewed cost → new partition
    pf_new = repartition(pf_old, w)
    assert not np.array_equal(pf_old.parts, pf_new.parts)

    rng = np.random.default_rng(0)
    u = rng.random(fes.ndof_scalar)
    u_old = jnp.asarray(pfespace.scatter_global(pf_old, u))
    tm = transfer_map(pf_old, pf_new)
    u_new = tm(u_old)
    expect = pfespace.scatter_global(pf_new, u)
    assert np.allclose(np.asarray(u_new), expect, atol=0)


def test_roundtrip_global():
    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 3)
    pf_old = pfespace.build(fes, 8)
    pf_new = repartition(pf_old)                 # uniform re-balance
    rng = np.random.default_rng(1)
    u = rng.random(fes.ndof_scalar)
    u_new = transfer_map(pf_old, pf_new)(
        jnp.asarray(pfespace.scatter_global(pf_old, u))
    )
    back = pfespace.gather_global(pf_new, np.asarray(u_new))
    assert np.array_equal(back, u)
