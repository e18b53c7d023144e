"""End-to-end Poisson (the ex1 vertical): exactness on polynomial solutions,
convergence rates vs manufactured solutions (reference analog:
tests/convergence/rates.cpp), and CG+Jacobi behavior."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.gridfunction import h1_seminorm_error, l2_error
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.models import poisson


def test_exact_polynomial_2d():
    """u = x² + y² solves -Δu = -4 and lies in the p=2 space ⇒ solver must
    recover it to solver tolerance."""
    mesh = make_cartesian_2d(4, 4)

    def u_exact(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 + x[..., 1] ** 2

    res = poisson.solve(
        mesh, order=2, rhs=lambda x: -4.0 * np.ones(np.asarray(x).shape[:-1]),
        bc=u_exact, rel_tol=1e-14,
    )
    assert res.converged
    err = float(l2_error(res.fes, res.u, u_exact))
    assert err < 1e-10, err


@pytest.mark.parametrize("order", [1, 2, 3])
def test_convergence_rate_2d(order):
    """L2 error rate ≈ p+1 on sin(πx)sin(πy)."""
    errs, hs = [], []
    for n in (4, 8, 16):
        mesh = make_cartesian_2d(n, n)

        def u_exact(x):
            x = np.asarray(x)
            return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

        def f(x):
            return 2 * np.pi**2 * u_exact(x)

        res = poisson.solve(mesh, order=order, rhs=f, rel_tol=1e-13)
        assert res.converged
        errs.append(float(l2_error(res.fes, res.u, u_exact)))
        hs.append(1.0 / n)
    rate = np.log(errs[-2] / errs[-1]) / np.log(hs[-2] / hs[-1])
    assert rate > order + 0.7, (errs, rate)


def test_convergence_rate_3d_order2():
    errs = []
    for n in (2, 4):
        mesh = make_cartesian_3d(n, n, n)

        def u_exact(x):
            x = np.asarray(x)
            return (
                np.sin(np.pi * x[..., 0])
                * np.sin(np.pi * x[..., 1])
                * np.sin(np.pi * x[..., 2])
            )

        def f(x):
            return 3 * np.pi**2 * u_exact(x)

        res = poisson.solve(mesh, order=2, rhs=f, rel_tol=1e-13)
        assert res.converged
        errs.append(float(l2_error(res.fes, res.u, u_exact)))
    rate = np.log(errs[0] / errs[1]) / np.log(2.0)
    assert rate > 2.7, (errs, rate)


def test_h1_rate_2d():
    errs = []
    for n in (4, 8):
        mesh = make_cartesian_2d(n, n)

        def u_exact(x):
            x = np.asarray(x)
            return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

        def grad_exact(x):
            x = np.asarray(x)
            return np.stack(
                [
                    np.pi * np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
                    np.pi * np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
                ],
                axis=-1,
            )

        def f(x):
            return 2 * np.pi**2 * u_exact(x)

        res = poisson.solve(mesh, order=2, rhs=f, rel_tol=1e-13)
        errs.append(float(h1_seminorm_error(res.fes, res.u, grad_exact)))
    rate = np.log(errs[0] / errs[1]) / np.log(2.0)
    assert rate > 1.7, (errs, rate)


def test_variable_coefficient_and_chebyshev():
    mesh = make_cartesian_2d(8, 8)

    def kappa(x):
        x = np.asarray(x)
        return 1.0 + x[..., 0] + x[..., 1]

    res_j = poisson.solve(mesh, order=2, rhs=1.0, kappa=kappa, rel_tol=1e-10)
    res_c = poisson.solve(
        mesh, order=2, rhs=1.0, kappa=kappa, rel_tol=1e-10,
        preconditioner="chebyshev",
    )
    assert res_j.converged and res_c.converged
    # chebyshev should take (weakly) fewer iterations than jacobi
    assert res_c.iterations <= res_j.iterations
    err = float(l2_error(res_j.fes, res_j.u, lambda x: 0 * np.asarray(x)[..., 0]))
    diff = np.abs(np.asarray(res_j.u) - np.asarray(res_c.u)).max()
    assert diff < 1e-7


def test_curved_annulus_high_order():
    """Curved (isoparametric) geometry: Poisson on a quarter annulus mapped
    from a rectangle; order-3 elements with order-3 geometry must converge at
    ~4th order in L2 (straight Q1 geometry would stall at 2nd order)."""
    from cardiac_ablation_ecm2.mesh.mesh import curve_mesh
    from cardiac_ablation_ecm2.fem.convergence import ConvergenceStudy

    def annulus(x):
        x = np.asarray(x)
        r = 1.0 + x[..., 0]
        th = 0.5 * np.pi * x[..., 1]
        return np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)

    def u_exact(x):
        x = np.asarray(x)
        r2 = x[..., 0] ** 2 + x[..., 1] ** 2
        return np.log(r2) / np.log(4.0)     # harmonic; u=0 at r=1, 1 at r=2

    study = ConvergenceStudy()
    for n in (2, 4, 8):
        base = make_cartesian_2d(n, n)
        mesh = curve_mesh(base, annulus, order=3)
        res = poisson.solve(
            mesh, order=3, rhs=lambda x: 0 * np.asarray(x)[..., 0],
            bc=u_exact, rel_tol=1e-13,
        )
        assert res.converged
        err = float(l2_error(res.fes, res.u, u_exact))
        study.add(1.0 / n, res.fes.ndof_scalar, err)
    assert study.asymptotic_rate() > 3.5, study.report()
