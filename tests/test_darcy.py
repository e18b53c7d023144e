"""Mixed Darcy (ex5 analog): manufactured-solution convergence on RT0×P0."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models import darcy


def p_exact(x):
    """sin·sin vanishes on ∂Ω — consistent with the natural p=0 BC of the
    mixed weak form."""
    x = np.asarray(x)
    return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])


def u_exact(x):
    """u = −∇p (f = u + ∇p = 0)."""
    x = np.asarray(x)
    return np.stack(
        [
            -np.pi * np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
            -np.pi * np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
        ],
        axis=-1,
    )


def g_exact(x):
    """div u = 2π² sin sin."""
    return 2 * np.pi**2 * p_exact(x)


def solve_on(n):
    mesh = make_cartesian_2d(n, n)
    res = darcy.solve(mesh, f_vec=None, g_fn=g_exact, rel_tol=1e-11,
                      max_iter=8000)
    assert res.converged, res.iterations
    # errors via element quadrature
    from cardiac_ablation_ecm2.ops.vecfe import build_rt_operator

    M = res.rt and None
    op = build_rt_operator(res.rt, mass_coeff=1.0)
    gf = op.gf
    name, qd, Bq = op.terms[0]
    e = res.u[op.gather] * op.signs
    uq = jnp.einsum("eqnc,en->eqc", Bq, e)           # physical u at qpts
    du = uq - jnp.asarray(u_exact(np.asarray(gf.x)))
    err_u = float(jnp.sqrt(jnp.sum(gf.wdet * jnp.sum(du**2, axis=-1))))
    # pressure: P0 per element vs exact mean
    pe = np.asarray(res.p)[res.l2.gather_map[:, 0]]
    pq = p_exact(np.asarray(gf.x))
    pex_mean = np.sum(np.asarray(gf.wdet) * pq, axis=1) / np.sum(
        np.asarray(gf.wdet), axis=1
    )
    wvol = np.sum(np.asarray(gf.wdet), axis=1)
    err_p = float(np.sqrt(np.sum(wvol * (pe - pex_mean) ** 2)))
    return err_u, err_p


def test_darcy_convergence():
    eu1, ep1 = solve_on(4)
    eu2, ep2 = solve_on(8)
    assert eu2 < 0.65 * eu1, (eu1, eu2)      # ~O(h) velocity
    assert ep2 < 0.65 * ep1, (ep1, ep2)
