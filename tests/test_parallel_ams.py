"""Sharded (in-shard_map) AMS preconditioner — parallel/pvecfe.py
``precond="ams"``.

The sharded analog of linalg/ams.py (HypreAMS, linalg/hypre.hpp:1984):
element-mediated de Rham transfers over the existing local-scatter +
ppermute halo machinery, Chebyshev auxiliary H1 sweeps.  Run on the
8-virtual-device CPU mesh (tests/conftest.py)."""

import numpy as np

from cardiac_ablation_ecm2.fem.fe_vector import NDSpace
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.parallel import pvecfe


def _rhs(x):
    return np.stack(
        [1.0 + x[..., 0] * x[..., 1], x[..., 1] ** 2 - x[..., 2],
         np.exp(x[..., 0])], axis=-1)


def test_sharded_ams_matches_jacobi_solution_with_fewer_iters():
    results = {}
    for n in (6, 8):
        mesh = make_cartesian_3d(n, n, n)
        nd = NDSpace(mesh)
        bdr = sorted(set(mesh.bdr_attributes.tolist()))
        row = {}
        for prec in ("jacobi", "ams"):
            pv = pvecfe.setup(nd, mass_coeff=1.0, curlcurl_coeff=1.0,
                              rhs_fn=_rhs, ess_bdr=bdr, rel_tol=1e-10,
                              precond=prec)
            row[prec] = pv.solve()
        uj = np.asarray(row["jacobi"][0])
        ua = np.asarray(row["ams"][0])
        scale = np.abs(uj).max()
        assert np.abs(uj - ua).max() < 1e-8 * max(scale, 1.0)
        results[n] = (int(row["jacobi"][1]), int(row["ams"][1]))
    # AMS beats Jacobi and stays near-flat while Jacobi grows
    assert results[8][1] < results[8][0] / 3
    assert results[8][1] <= results[6][1] + 6
    assert results[8][0] > 1.3 * results[6][0]
