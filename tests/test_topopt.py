"""SIMP topology optimization (ex37-class compliance minimization)."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2.models.topopt import TopOpt


def _beam(nx=16, ny=8):
    m0 = make_cartesian_2d(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] *= 2.0
    return Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                attributes=m0.attributes, boundary=m0.boundary,
                bdr_attributes=m0.bdr_attributes)


def test_cantilever_optimization():
    opt = TopOpt(_beam(), volfrac=0.4, filter_radius=0.3)
    rho, u, hist = opt.optimize(n_iter=20)
    # compliance decreases substantially and monotonically-ish
    assert hist[-1] < 0.6 * hist[0], (hist[0], hist[-1])
    assert all(b <= a * 1.02 for a, b in zip(hist, hist[1:]))
    # volume constraint satisfied
    vol = float(opt.vol_e @ rho) / float(opt.vol_e.sum())
    assert abs(vol - 0.4) < 0.02
    # design polarizes toward 0/1
    r = np.asarray(rho)
    assert (r > 0.7).mean() > 0.03 and (r < 0.2).mean() > 0.05


def test_full_density_matches_plain_elasticity():
    """ρ ≡ 1 reduces the solve to standard elasticity compliance."""
    opt = TopOpt(_beam(8, 4), volfrac=1.0, E_min=0.0)
    import jax.numpy as jnp

    rho = jnp.ones(opt.mesh.ne)
    u, info = opt._solve(rho)
    assert bool(info.converged)
    c = float(opt.b @ u)
    # compare with the packaged elasticity model on the same problem
    from cardiac_ablation_ecm2.models import elasticity as emodel

    res = emodel.solve(opt.mesh, order=1, lam=1.0, mu=1.0,
                       fixed_bdr=[4], force_bdr=[2], force=(0.0, -1.0))
    c_ref = float(opt.b @ res.u)
    assert np.isclose(c, c_ref, rtol=1e-8), (c, c_ref)
