"""ConvergenceStudy analog (fem/convergence.cpp): observed rates on a real
Poisson refinement ladder."""

import io

import numpy as np

from cardiac_ablation_ecm2.fem.convergence import ConvergenceStudy, study
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models import poisson


def test_rates_synthetic():
    cs = ConvergenceStudy(dim=2)
    for k in range(4):
        h = 0.5 ** k
        cs.add_level(3.0 * h ** 2, int((1 / h) ** 2), h=h)
    assert np.allclose(cs.rates(), 2.0)
    assert abs(cs.rate() - 2.0) < 1e-12
    assert cs.nlevels == 4
    buf = io.StringIO()
    cs.print(buf)
    assert "rate" in buf.getvalue() and "2.00" in buf.getvalue()


def test_poisson_ladder_rate():
    """Order-2 Poisson with the manufactured sin·sin solution converges at
    rate ~3 in L2 — through the study() driver."""

    def solve(n):
        mesh = make_cartesian_2d(n, n)
        res = poisson.solve(
            mesh, order=2, rhs=lambda x: 2 * np.pi ** 2 *
            np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
            rel_tol=1e-12)
        from cardiac_ablation_ecm2.fem.gridfunction import l2_error

        err = l2_error(
            res.fes, res.u, lambda x: np.sin(np.pi * x[..., 0]) *
            np.sin(np.pi * x[..., 1]))
        return float(err), res.fes.ndof

    cs = study(solve, [4, 8, 16], dim=2)
    assert cs.rate() > 2.7, (cs.errors, cs.rates())
