"""Dynamic AMR: refine + derefine + conforming solve through the cycle
(ex15-class; reference NCMesh derefinement mesh/ncmesh.hpp:241-247,
ThresholdDerefiner mesh/mesh_operators.hpp:274)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.estimators import zz_estimator
from cardiac_ablation_ecm2.fem.gridfunction import l2_error, project
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.mesh.amr import interp_after_refine
from cardiac_ablation_ecm2.mesh.forest import (
    AMRForest,
    threshold_derefine_nc,
    threshold_refine_nc,
)
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def test_refine_then_derefine_roundtrip_quads():
    """Refining a block and fully derefining restores the active count."""
    forest = AMRForest(make_cartesian_2d(4, 4))
    ne0 = len(forest.active)
    marks = np.zeros(ne0, bool)
    marks[[5, 6]] = True
    forest.refine(marks)
    ne1 = len(forest.active)
    assert ne1 == ne0 + 2 * 3          # two 4-way splits
    forest.derefine(np.ones(ne1, bool))
    assert len(forest.active) == ne0
    m = forest.mesh()
    assert m.nbe == 16                  # boundary restored


def test_refine_then_derefine_roundtrip_hexes():
    forest = AMRForest(make_cartesian_3d(2, 2, 2))
    ne0 = len(forest.active)
    marks = np.zeros(ne0, bool)
    marks[0] = True
    forest.refine(marks)
    ne1 = len(forest.active)
    assert ne1 == ne0 + 7
    forest.derefine(np.ones(ne1, bool))
    assert len(forest.active) == ne0
    assert forest.mesh().nbe == 24


def test_derefine_respects_balance_quads():
    """A derefinement that would create a >2:1 jump is refused."""
    forest = AMRForest(make_cartesian_2d(2, 2))
    forest.refine(np.array([True, False, False, False]))
    # refine one child of the refined block again -> depth-2 next to depth-1
    ne = len(forest.active)
    marks = np.zeros(ne, bool)
    marks[0] = True
    forest.refine(marks)
    # now try to derefine EVERYTHING; the forest must keep enough depth-1
    # elements around the depth-2 cluster to preserve 2:1
    changed = forest.derefine(np.ones(len(forest.active), bool))
    m = forest.mesh()
    from cardiac_ablation_ecm2.mesh.ncmesh import make_nc
    from cardiac_ablation_ecm2.mesh.forest import _bad_master_edges

    nc = make_nc(m)
    assert not _bad_master_edges(nc.constraints)


def _solve_nc(nc, u_exact, f_rhs, p=2):
    sp = NCFESpace(nc, p)
    fes = sp.fes
    A_L = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = jnp.asarray(sp.essential_dofs())
    xb = jnp.asarray(u_exact(sp.dof_coords))
    bL = domain_lf(fes, f_rhs)

    def AC(x):
        z = x.at[ess].set(0.0)
        y = sp.restrict_t(A_L.mult(sp.prolongate(z)))
        return y.at[ess].set(x[ess])

    w = jnp.zeros(sp.ndof_conf).at[ess].set(xb[ess])
    b = sp.restrict_t(bL) - sp.restrict_t(A_L.mult(sp.prolongate(w)))
    b = b.at[ess].set(xb[ess])
    x, info = cg(AC, b, rel_tol=1e-10, max_iter=4000)
    assert bool(info.converged)
    return sp, sp.prolongate(x)


def test_ex15_moving_front_loop():
    """Moving-bump dynamic AMR: refine tracks the bump, derefinement prunes
    the wake; error stays low while the element count stays bounded."""
    t_vals = [0.0, 0.25, 0.5]

    def make_u(t):
        cx = 0.25 + t

        def u(x):
            x = np.asarray(x)
            return np.exp(-80.0 * ((x[..., 0] - cx) ** 2
                                   + (x[..., 1] - 0.5) ** 2))

        def f(x):
            x = np.asarray(x)
            a = 80.0
            r2 = (x[..., 0] - cx) ** 2 + (x[..., 1] - 0.5) ** 2
            return (4 * a - 4 * a * a * r2) * np.exp(-a * r2)

        return u, f

    forest = AMRForest(make_cartesian_2d(8, 8))
    errs, counts = [], []
    for t in t_vals:
        u_ex, f = make_u(t)
        # a couple of refine sweeps per time level
        for _ in range(2):
            nc = forest.nc()
            sp, uL = _solve_nc(nc, u_ex, f)
            eta = np.asarray(zz_estimator(sp.fes, uL))
            if not threshold_refine_nc(forest, eta, frac=0.5,
                                       max_elements=700):
                break
        nc = forest.nc()
        sp, uL = _solve_nc(nc, u_ex, f)
        eta = np.asarray(zz_estimator(sp.fes, uL))
        threshold_derefine_nc(forest, eta, threshold=0.3 * eta.max())
        nc = forest.nc()
        sp, uL = _solve_nc(nc, u_ex, f)
        errs.append(float(l2_error(sp.fes, uL, u_ex)))
        counts.append(len(forest.active))
    # error bounded and small at every time level, mesh doesn't blow up
    assert all(e < 2e-3 for e in errs), errs
    assert counts[-1] < 700
    # derefinement actually happened at some point (wake pruned): the final
    # count is far below naive accumulation (3 levels x 2 sweeps of growth)
    assert counts[-1] < counts[0] * 3, counts
