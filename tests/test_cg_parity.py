"""CG-iteration-count parity with MFEM (BASELINE.json metric 2).

Golden values generated 2026-08-16 with a driver built against the reference
library (libmfem.a): Poisson −Δu = 1, u = 0 on all boundary attributes,
PARTIAL assembly, OperatorJacobiSmoother-preconditioned CG, rel_tol 1e-12,
identical stopping criterion ((Br,r) ≤ rel²·(Br0,r0) — linalg/solvers.cpp).
Driver source: the parity.cpp tool (kept outside the repo; see BASELINE.md
"CG iteration parity" for the regeneration recipe).

Our CG must reproduce MFEM's iteration counts EXACTLY — same operator, same
preconditioner, same criterion, f64 arithmetic.
"""

import pytest

from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
from cardiac_ablation_ecm2.models import poisson

DATA = "/root/reference/data"

# (mesh, order, uniform refinements) -> (ndof, MFEM CG iterations)
GOLDEN = {
    ("star.mesh", 1, 0): (31, 7),
    ("star.mesh", 2, 0): (101, 21),
    ("star.mesh", 3, 0): (211, 39),
    ("fichera.mesh", 2, 0): (117, 6),
    ("beam-hex.mesh", 2, 0): (153, 8),
    ("inline-quad.mesh", 2, 0): (81, 10),
    ("star.mesh", 2, 2): (1361, 97),
    ("fichera.mesh", 2, 2): (4401, 49),
    ("beam-hex.mesh", 2, 1): (825, 22),
}


@pytest.fixture
def _mfem_analog_path():
    """Pin the per-qpt PA apply: MFEM streams per-quad-point qdata, and
    exact iteration parity at rel_tol 1e-12 is a statement about matching
    that rounding path bit-for-bit.  The affine separable-qdata collapse
    (ops/lanemajor.py) refactors the same sums through precomputed
    reference matrices — algebraically identical, but the different
    association can legitimately shift a count by ±1 at the last bit
    (observed: star.mesh p2 converges in 20 instead of 21)."""
    from cardiac_ablation_ecm2.utils.config import config, configure

    old = config.affine_collapse
    configure(affine_collapse="off")
    yield
    configure(affine_collapse=old)


@pytest.mark.parametrize("mf,order,refs", sorted(GOLDEN))
def test_cg_iteration_parity(mf, order, refs, _mfem_analog_path):
    ndof, iters = GOLDEN[(mf, order, refs)]
    m = read_mfem_mesh(f"{DATA}/{mf}")
    if refs:
        m = m.uniform_refinement(refs)
    res = poisson.solve(m, order=order, rel_tol=1e-12, max_iter=4000)
    assert res.fes.ndof == ndof
    assert res.converged
    assert res.iterations == iters, (res.iterations, iters)


def test_affine_path_iterations_within_one():
    """The affine fast path may differ from the MFEM-rounding path by at
    most one CG iteration on every parity config (same operator algebra)."""
    for (mf, order, refs), (ndof, iters) in sorted(GOLDEN.items()):
        m = read_mfem_mesh(f"{DATA}/{mf}")
        if refs:
            m = m.uniform_refinement(refs)
        res = poisson.solve(m, order=order, rel_tol=1e-12, max_iter=4000)
        assert res.converged
        assert abs(res.iterations - iters) <= 1, (mf, order, refs,
                                                  res.iterations, iters)
