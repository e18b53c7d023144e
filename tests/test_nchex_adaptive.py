"""ex6-style adaptive loop on NC HEX meshes: solve → ZZ-estimate → mark →
2:1 refine → solve; error must drop monotonically and the NC solve must
stay conforming at every step."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.estimators import zz_estimator
from cardiac_ablation_ecm2.fem.gridfunction import l2_error
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.mesh.ncmesh import make_nc, refine_hexes
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def u_exact(x):
    x = np.asarray(x)
    # steep localized bump near the (0,0,0) corner — drives corner refinement
    r2 = (x**2).sum(axis=-1)
    return np.exp(-30.0 * r2)


def f_rhs(x):
    x = np.asarray(x)
    r2 = (x**2).sum(axis=-1)
    # -Δ exp(-a r²) = (6a − 4a² r²) exp(-a r²), a = 30
    a = 30.0
    return (6 * a - 4 * a * a * r2) * np.exp(-a * r2)


def solve_nc(nc, p=2):
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
    uL = sp.prolongate(x)
    return sp, uL, l2_error(fes, uL, u_exact)


def test_adaptive_hex_loop():
    nc = make_nc(make_cartesian_3d(3, 3, 3))
    errs, ndofs = [], []
    for it in range(3):
        sp, uL, err = solve_nc(nc)
        errs.append(float(err))
        ndofs.append(sp.ndof_conf)
        eta = zz_estimator(sp.fes, uL)
        marks = np.asarray(eta) > 0.3 * float(np.asarray(eta).max())
        nc, _ = refine_hexes(nc, marks)
    sp, uL, err = solve_nc(nc)
    errs.append(float(err))
    ndofs.append(sp.ndof_conf)
    # error decreases every round; hanging nodes actually appear
    assert all(errs[i + 1] < errs[i] for i in range(len(errs) - 1)), errs
    assert errs[-1] < 0.25 * errs[0], (errs, ndofs)
    assert sp.n_slaves > 0
