"""AMR composite loops: elasticity-driven (ex21) and unresolved-data
(ex30) adaptivity built from shipped pieces."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.estimators import zz_estimator
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.amr import threshold_refine
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_2d_tri
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import boundary_lf_vector


def test_ex21_amr_elasticity():
    """Cantilever elasticity + per-component ZZ marking: the refined mesh
    concentrates elements near the clamped corners (stress concentration)
    and the compliance stabilizes monotonically."""
    mesh = make_cartesian_2d_tri(8, 4)

    def solve(mesh):
        fes = FESpace(mesh, 1, vdim=2)
        ns = fes.ndof_scalar
        A = BilinearForm(fes).add_domain_integrator(
            "elasticity", coeff=(1.0, 1.0)).assemble()
        b = boundary_lf_vector(fes, np.array([0.0, -1.0]), bdr_marker=[2])
        ess_s = fes.essential_dofs([4])
        ess = np.concatenate([ess_s, ess_s + ns])
        m = jnp.ones(fes.ndof).at[jnp.asarray(ess)].set(0.0)
        Ac = lambda v: A.mult(v * m) * m + v * (1 - m)
        d = A.diagonal() * m + (1 - m)
        u, info = cg(Ac, b * m, M=lambda r: r / d, rel_tol=1e-10,
                     max_iter=4000)
        assert bool(info.converged)
        return fes, u, float(b @ u)

    comps = []
    for _round in range(3):
        fes, u, c = solve(mesh)
        comps.append(c)
        ns = fes.ndof_scalar
        sfes = FESpace(mesh, 1)
        eta = np.zeros(mesh.ne)
        for comp in range(2):
            eta += zz_estimator(sfes, u[comp * ns:(comp + 1) * ns]) ** 2
        eta = np.sqrt(eta)
        mesh, _, _ = threshold_refine(mesh, eta, frac=0.7)
    # compliance is a monotone-converging quantity under refinement
    assert comps[2] >= comps[0] * 0.99
    # refinement concentrated: elements grew but far less than uniform 4^2
    assert mesh.ne < 16 * 8 * 4 * 2


def test_ex30_unresolved_data_refinement():
    """A sharp coefficient bump unresolved on the coarse mesh: project,
    estimate the projection error elementwise, refine until the data is
    resolved — element count grows only near the bump."""
    from cardiac_ablation_ecm2.fem.build import (
        basis_for,
        geom_factors_for,
    )
    from cardiac_ablation_ecm2.fem.gridfunction import project
    from cardiac_ablation_ecm2.fem.quadinterp import eval_values
    from cardiac_ablation_ecm2.fem.restriction import ElementRestriction

    def f(x):
        x = np.asarray(x)
        return np.exp(-300 * ((x[..., 0] - 0.3) ** 2
                              + (x[..., 1] - 0.6) ** 2))

    from cardiac_ablation_ecm2.fem.build import restriction_for

    mesh = make_cartesian_2d_tri(4, 4)
    errs = []
    for _round in range(7):
        fes = FESpace(mesh, 1)
        u = project(fes, f)
        gf = geom_factors_for(fes)
        uq = eval_values(basis_for(fes), restriction_for(fes).mult(u))
        fq = f(np.asarray(gf.x))
        eta = np.sqrt(np.asarray(
            jnp.sum(gf.wdet * (uq - jnp.asarray(fq)) ** 2, axis=1)))
        errs.append(float(np.sqrt((eta ** 2).sum())))
        if _round < 6:
            mesh, _, _ = threshold_refine(mesh, eta, frac=0.3)
    # nodal interpolation of a sharp bump is not monotone under early
    # refinement; require a solid overall reduction once resolved
    assert errs[-1] < 0.3 * errs[0], errs
    # localized: element count far below uniform 4-level refinement
    assert mesh.ne < 4 * 4 * 2 * 4 ** 3
