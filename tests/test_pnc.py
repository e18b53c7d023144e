"""Sharded NC (hanging-node) Poisson vs serial NCFESpace (ParNCMesh
analog with a ghost master layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.ncmesh import make_nc, refine_quads
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf
from cardiac_ablation_ecm2.parallel import pnc


def _nc_mesh(rounds=2, n=4):
    nc = make_nc(make_cartesian_2d(n, n))
    for r in range(rounds):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        marks = (cent[:, 0] < 0.5 ** (r + 1)) & (cent[:, 1] < 0.5 ** (r + 1))
        nc, _ = refine_quads(nc, marks)
    return nc


def _serial_solve(sp, rel_tol=1e-12):
    fes = sp.fes
    A_L = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    b_L = domain_lf(fes, lambda x: 1.0 + 0 * np.asarray(x)[..., 0])
    ess = jnp.asarray(sp.essential_dofs())
    m = jnp.ones(sp.ndof_conf).at[ess].set(0.0)

    def AC(x):
        z = x * m
        y = sp.restrict_t(A_L.mult(sp.prolongate(z)))
        return y * m + (x - z)

    b = sp.restrict_t(b_L) * m
    u, info = cg(AC, b, rel_tol=rel_tol, max_iter=4000)
    assert bool(info.converged)
    return np.asarray(u), info.iterations


@pytest.mark.parametrize("order,rounds", [(1, 2), (2, 2), (3, 1)])
def test_sharded_nc_matches_serial(order, rounds):
    nc = _nc_mesh(rounds)
    sp = NCFESpace(nc, order)
    assert sp.n_slaves > 0
    u_ser, it_ser = _serial_solve(sp)

    solver = pnc.setup(sp, ndev=8, rel_tol=1e-12,
                       devices=jax.devices("cpu"))
    u_par, it_par, final = solver.solve()
    err = np.abs(u_par - u_ser).max()
    scale = max(np.abs(u_ser).max(), 1e-30)
    assert err < 1e-8 * scale, (err, scale)


def test_ghost_layer_built():
    """At p≥2 some devices must import ghost master dofs (interior edge
    dofs of the coarse side of an NC interface)."""
    nc = _nc_mesh(2)
    sp = NCFESpace(nc, 2)
    solver = pnc.setup(sp, ndev=8, devices=jax.devices("cpu"))
    # at least one device's local dof set exceeds its element dofs
    pf = solver.pf
    gm = sp.fes.gather_map.astype(np.int64)
    grew = False
    for d in range(pf.ndev):
        own = np.unique(gm[pf.parts == d].reshape(-1))
        have = pf.loc2glob[d]
        have = have[have >= 0]
        if len(have) > len(own):
            grew = True
    assert grew
