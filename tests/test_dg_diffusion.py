"""SIPG DG diffusion (ex14 analog): symmetry, coercivity, and convergence to
the exact solution with weak Dirichlet BCs."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.quadinterp import eval_values, eval_values_t
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops.dg_diffusion import DGDiffusion


def test_sipg_symmetry_and_coercivity():
    mesh = make_cartesian_2d(4, 3)
    fes = L2FESpace(mesh, 2)
    op = DGDiffusion(fes, kappa=1.0)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(fes.ndof))
    y = jnp.asarray(rng.random(fes.ndof))
    axy = float(jnp.vdot(op.mult(x), y))
    ayx = float(jnp.vdot(op.mult(y), x))
    assert np.isclose(axy, ayx, rtol=1e-10), (axy, ayx)
    assert float(jnp.vdot(x, op.mult(x))) > 0


@pytest.mark.parametrize("p", [1, 2])
def test_sipg_poisson_convergence(p):
    """−Δu = f with u* = sin(πx)sin(πy): L2 error rate ≈ p+1."""

    def u_exact(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    def f(x):
        return 2 * np.pi**2 * u_exact(x)

    errs = []
    for n in (8, 16):
        mesh = make_cartesian_2d(n, n)
        fes = L2FESpace(mesh, p)
        op = DGDiffusion(fes, kappa=1.0)
        gf = geom_factors_for(fes)
        db = basis_for(fes)
        fq = jnp.asarray(f(np.asarray(gf.x)))
        b = eval_values_t(db, gf.wdet * fq).reshape(-1)
        b = b + op.dirichlet_rhs(lambda x: np.zeros(x.shape[:-1]))
        diag = op.diagonal()
        x, info = cg(op.mult, b, M=lambda r: r / diag, rel_tol=1e-11,
                     max_iter=4000)
        assert bool(info.converged), int(info.iterations)
        uq = eval_values(db, x.reshape(mesh.ne, fes.nd_elem))
        err = float(jnp.sqrt(jnp.sum(
            gf.wdet * (uq - jnp.asarray(u_exact(np.asarray(gf.x)))) ** 2
        )))
        errs.append(err)
    rate = np.log2(errs[0] / errs[1])
    assert rate > p + 0.6, (errs, rate)


def test_sipg_nonzero_dirichlet():
    """u* = x² + y² (exact in p=2 space): weak Dirichlet recovers it."""
    mesh = make_cartesian_2d(5, 5)
    fes = L2FESpace(mesh, 2)
    op = DGDiffusion(fes, kappa=1.0)
    gf = geom_factors_for(fes)
    db = basis_for(fes)

    def u_exact(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 + x[..., 1] ** 2

    fq = jnp.full(gf.det.shape, -(-4.0))  # f = −Δu = −4
    b = eval_values_t(db, gf.wdet * (-4.0)).reshape(-1)
    b = b + op.dirichlet_rhs(u_exact)
    diag = op.diagonal()
    x, info = cg(op.mult, b, M=lambda r: r / diag, rel_tol=1e-13, max_iter=6000)
    assert bool(info.converged)
    uq = eval_values(db, x.reshape(mesh.ne, fes.nd_elem))
    err = float(jnp.abs(uq - jnp.asarray(u_exact(np.asarray(gf.x)))).max())
    assert err < 1e-8, err
