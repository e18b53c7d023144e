"""Sharded DG with ghost-face exchange (VERDICT r1 item 5): advection and
SIPG diffusion on 8 virtual devices must match the serial operators.
Reference: ParMesh::ExchangeFaceNbrData (mesh/pmesh.cpp:2079),
ParL2FaceRestriction (fem/prestriction.hpp:139)."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for
from cardiac_ablation_ecm2.fem.fespace import L2FESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values_t
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops.dg_advection import DGAdvection, project_l2
from cardiac_ablation_ecm2.ops.dg_diffusion import DGDiffusion
from cardiac_ablation_ecm2.parallel import dg as pdg


def _vel(x):
    mod = jnp if not isinstance(x, np.ndarray) else np
    return mod.stack(
        [0.6 * mod.ones_like(x[..., 0]), 0.4 * mod.ones_like(x[..., 1])],
        axis=-1,
    )


def _zero(x):
    return np.zeros(np.asarray(x).shape[:-1])


def test_sharded_dg_advection_matches_serial():
    mesh = make_cartesian_2d(8, 8)
    fes = L2FESpace(mesh, 2)
    op = DGAdvection(fes=fes, velocity=_vel, inflow=_zero)
    par = pdg.setup(fes, velocity=_vel, inflow=_zero, ndev=8)

    u0 = project_l2(fes, lambda X: np.exp(
        -60 * ((X[..., 0] - 0.4) ** 2 + (X[..., 1] - 0.5) ** 2)))
    us = par.scatter(u0)

    dt, t = 0.004, 0.0
    u_s, u_p = u0, us

    def rk4(mult, u, t):
        k1 = mult(t, u)
        k2 = mult(t + dt / 2, u + dt / 2 * k1)
        k3 = mult(t + dt / 2, u + dt / 2 * k2)
        k4 = mult(t + dt, u + dt * k3)
        return u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    for _ in range(5):
        u_s = rk4(op.mult, u_s, t)
        u_p = rk4(par.mult, u_p, t)
        t += dt
    assert np.abs(par.gather(u_p) - np.asarray(u_s)).max() < 1e-12


def test_sharded_sipg_matches_serial():
    mesh = make_cartesian_2d(6, 6)
    fes = L2FESpace(mesh, 2)

    def f(x):
        mod = jnp if not isinstance(x, np.ndarray) else np
        return (2 * np.pi ** 2 * mod.sin(np.pi * x[..., 0])
                * mod.sin(np.pi * x[..., 1]))

    ser = DGDiffusion(fes=fes, kappa=1.0, penalty=10.0)
    gf = geom_factors_for(fes)
    db = basis_for(fes)
    b = ser.dirichlet_rhs(_zero) + eval_values_t(
        db, gf.wdet * jnp.asarray(f(np.asarray(gf.x)))).reshape(-1)
    dd = ser.diagonal()
    x_s, info_s = cg(ser.mult, b, M=lambda r: r / dd, rel_tol=1e-10,
                     max_iter=2000)

    par = pdg.setup_sipg(fes, kappa=1.0, penalty=10.0, g=_zero, f_rhs=f,
                         ndev=8)
    x_p, (iters, _) = par.solve(rel_tol=1e-10, max_iter=2000)
    assert np.abs(par.gather(x_p) - np.asarray(x_s)).max() < 1e-8
    assert iters == int(info_s.iterations)    # identical CG trajectory


def test_sharded_sipg_3d():
    mesh = make_cartesian_3d(3, 3, 3)
    fes = L2FESpace(mesh, 1)
    ser = DGDiffusion(fes=fes, kappa=2.0, penalty=12.0)
    gf = geom_factors_for(fes)
    db = basis_for(fes)
    b = eval_values_t(db, gf.wdet).reshape(-1)
    dd = ser.diagonal()
    x_s, _ = cg(ser.mult, b, M=lambda r: r / dd, rel_tol=1e-10,
                max_iter=2000)
    par = pdg.setup_sipg(fes, kappa=2.0, penalty=12.0,
                         f_rhs=lambda x: jnp.ones(x.shape[:-1]), ndev=8)
    x_p, _ = par.solve(rel_tol=1e-10, max_iter=2000)
    assert np.abs(par.gather(x_p) - np.asarray(x_s)).max() < 1e-8
