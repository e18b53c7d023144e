"""Sharded-vs-serial agreement over the virtual 8-device CPU mesh — the
analog of the reference's [Parallel] punit_tests under mpirun (SURVEY.md §4).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import restriction_for
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.models import poisson as serial_poisson
from cardiac_ablation_ecm2.parallel import partition, pfespace
from cardiac_ablation_ecm2.parallel import poisson as ppoisson


def test_rcb_balance():
    m = make_cartesian_3d(4, 4, 4)
    parts = partition.partition_mesh(m, 8)
    counts = np.bincount(parts, minlength=8)
    assert counts.min() >= 7 and counts.max() <= 9
    parts5 = partition.partition_mesh(m, 5)
    c5 = np.bincount(parts5, minlength=5)
    assert c5.max() - c5.min() <= 1


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_partitioned_scatter_consistency(ndev):
    """Local scatter + halo exchange == serial Rᵀ for random E-vectors."""
    from cardiac_ablation_ecm2.parallel import ops as pops
    from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 3)
    pf = pfespace.build(fes, ndev)
    R = restriction_for(fes)

    rng = np.random.default_rng(0)
    E = rng.random((mesh.ne, fes.nd_elem))
    y_serial = np.asarray(R.mult_transpose(jnp.asarray(E)))

    E_stacked = E[pf.elems] * pf.elem_weight[:, :, None]   # padded elems → 0
    dmesh = DeviceMesh(np.array(jax.devices()[:ndev]), ("d",))

    from functools import partial as fpartial

    @fpartial(
        shard_map, mesh=dmesh,
        in_specs=(P("d"),) * 4, out_specs=P("d"), check_vma=False,
    )
    def scatter_all(Es, pm, sg, sd):
        Es, pm, sg, sd = Es[0], pm[0], sg[0], sd[0]
        y = pops.local_scatter(Es, pm, sg, pf.nloc)
        y = pops.halo_sum(y, sd, pf.perms, pf.nloc)
        return y[None]

    y_loc = np.asarray(
        scatter_all(
            jnp.asarray(E_stacked),
            jnp.asarray(pf.scat_perm),
            jnp.asarray(pf.scat_seg),
            jnp.asarray(pf.send_idx),
        )
    )
    # every device must hold the fully assembled value for every dof it knows
    for d in range(ndev):
        g = pf.loc2glob[d]
        real = g >= 0
        assert np.allclose(y_loc[d, : pf.nloc][real], y_serial[g[real]],
                           atol=1e-12), d


@pytest.mark.parametrize("ndev", [2, 8])
def test_parallel_poisson_matches_serial(ndev):
    mesh = make_cartesian_2d(8, 8)

    def rhs(x):
        return 2 * jnp.pi**2 * jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(
            jnp.pi * x[..., 1]
        )

    def rhs_np(x):
        x = np.asarray(x)
        return 2 * np.pi**2 * np.sin(np.pi * x[..., 0]) * np.sin(
            np.pi * x[..., 1]
        )

    ser = serial_poisson.solve(mesh, order=2, rhs=rhs_np, rel_tol=1e-13)
    par = ppoisson.setup(mesh, order=2, ndev=ndev, rhs=rhs, rel_tol=1e-13)
    u_par, iters, final = par.solve()
    u_ser = np.asarray(ser.u)
    assert np.allclose(u_par, u_ser, atol=1e-9), np.abs(u_par - u_ser).max()
    # CG iteration parity with the serial run (same Jacobi preconditioner)
    assert abs(iters - ser.iterations) <= 2, (iters, ser.iterations)


def test_parallel_poisson_3d():
    mesh = make_cartesian_3d(3, 3, 3)

    def rhs(x):
        return jnp.ones(x.shape[:-1], x.dtype)

    ser = serial_poisson.solve(mesh, order=2, rhs=1.0, rel_tol=1e-13)
    par = ppoisson.setup(mesh, order=2, ndev=8, rhs=rhs, rel_tol=1e-13)
    u_par, iters, _ = par.solve()
    assert np.allclose(u_par, np.asarray(ser.u), atol=1e-9)
