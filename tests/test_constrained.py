"""ConstrainedSolver framework (reference: linalg/constraints.hpp, ex28).

Validates the three strategies (elimination/projection, penalty, Schur
saddle-point) against a dense KKT solve, and reproduces ex28's sliding
boundary conditions: a trapezoid pushed into a rigid notch with the normal
displacement constrained but tangential sliding allowed."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.constrained import (
    build_normal_constraints, eliminate_constrained_solve, from_rows,
    penalty_constrained_solve, schur_constrained_solve)
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import boundary_lf_vector


def test_against_dense_kkt():
    """All three strategies match the dense saddle-point solve."""
    rng = np.random.default_rng(3)
    n, m = 40, 5
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    rows = []
    for i in range(m):
        cols = rng.choice(n, size=3, replace=False)
        rows.append([(int(c), float(rng.standard_normal())) for c in cols])
    B = from_rows(rows, n, dtype=jnp.float64)
    f = rng.standard_normal(n)
    r = rng.standard_normal(m)

    Bd = np.zeros((m, n))
    for i, row in enumerate(rows):
        for c, v in row:
            Bd[i, c] += v
    K = np.block([[A, Bd.T], [Bd, np.zeros((m, m))]])
    ref = np.linalg.solve(K, np.concatenate([f, r]))
    x_ref, lam_ref = ref[:n], ref[n:]

    Amult = lambda v: jnp.asarray(A) @ v
    fj, rj = jnp.asarray(f), jnp.asarray(r)

    xe, le, ie = eliminate_constrained_solve(Amult, B, fj, r=rj,
                                             rel_tol=1e-13)
    assert np.allclose(np.asarray(xe), x_ref, atol=1e-8)
    assert np.allclose(np.asarray(le), lam_ref, atol=1e-6)

    xs, ls, isch = schur_constrained_solve(Amult, B, fj, r=rj,
                                           Adiag=jnp.asarray(np.diag(A)),
                                           rel_tol=1e-13)
    assert np.allclose(np.asarray(xs), x_ref, atol=1e-7)
    assert np.allclose(np.asarray(ls), lam_ref, atol=1e-5)

    xp, lp, ip = penalty_constrained_solve(Amult, B, fj, r=rj,
                                           penalty=1e10, rel_tol=1e-13)
    assert np.allclose(np.asarray(xp), x_ref, atol=1e-5)
    assert np.allclose(np.asarray(lp), lam_ref, rtol=1e-3, atol=1e-4)


def _trapezoid_mesh(nx=8, ny=8, offset=0.3):
    """ex28's trapezoid: unit square with the top-left corner pulled to
    (offset, 1) — bilinear map x' = x + (1-x)·offset·y."""
    m0 = make_cartesian_2d(nx, ny)
    V = m0.vertices.copy()
    V[:, 0] = V[:, 0] + (1.0 - V[:, 0]) * offset * V[:, 1]
    return Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                attributes=m0.attributes, boundary=m0.boundary,
                bdr_attributes=m0.bdr_attributes)


def test_ex28_sliding_trapezoid():
    """ex28 analog: normal-constrained attrs 1 (bottom) and 4 (slanted
    left), push force on attr 2.  The three solvers agree, the normal
    constraint holds, and the body slides tangentially."""
    mesh = _trapezoid_mesh()
    fes = FESpace(mesh, 1, vdim=2)
    ns = fes.ndof_scalar
    A = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()
    b = boundary_lf_vector(fes, np.array([-5.0e-2, 0.0]), bdr_marker=[2])
    B = build_normal_constraints(fes, [1, 4], dtype=jnp.float64)
    assert B.m > 0
    # the bottom-left corner node sits on both attrs → a 2-row block
    blocks = np.diff(B.rowstarts)
    assert blocks.max() == 2 and (blocks == 2).sum() == 1

    diag = A.diagonal()
    xe, le, ie = eliminate_constrained_solve(
        A.mult, B, b, M=lambda v: v / diag, rel_tol=1e-12, max_iter=4000)
    assert bool(ie.converged)
    xs, ls, _ = schur_constrained_solve(A.mult, B, b, Adiag=diag,
                                        rel_tol=1e-12, max_iter=8000)
    xp, lp, _ = penalty_constrained_solve(
        A.mult, B, b, penalty=1e10, M=lambda v: v / diag, rel_tol=1e-12,
        max_iter=8000)

    scale = float(jnp.abs(xe).max())
    assert np.allclose(np.asarray(xs), np.asarray(xe), atol=1e-6 * scale)
    assert np.allclose(np.asarray(xp), np.asarray(xe), atol=1e-4 * scale)

    # constraint satisfied: no normal displacement on attrs 1 and 4
    assert float(jnp.abs(B.mult(xe)).max()) < 1e-10 * scale
    # ... but tangential sliding happens: bottom nodes move in x
    bot = fes.essential_dofs([1])
    ux_bot = np.asarray(xe)[bot]
    assert np.abs(ux_bot).max() > 0.1 * scale
    # pushed from the right: net x-motion is negative
    assert np.asarray(xe)[:ns].mean() < 0
    # multipliers = normal contact forces; Schur and elimination agree
    assert np.allclose(np.asarray(ls), np.asarray(le), atol=1e-5 *
                       max(1.0, float(jnp.abs(le).max())))


def test_order2_normal_constraints():
    """Order-2 space: constraint rows cover the edge midside nodes too."""
    mesh = _trapezoid_mesh(4, 4)
    fes = FESpace(mesh, 2, vdim=2)
    B = build_normal_constraints(fes, [1, 4], dtype=jnp.float64)
    # attrs 1 and 4 each carry 2*4+1 = 9 nodes at p=2; corner shared
    assert B.m == 9 + 9
    A = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()
    b = boundary_lf_vector(fes, np.array([-5.0e-2, 0.0]), bdr_marker=[2])
    diag = A.diagonal()
    xe, _, ie = eliminate_constrained_solve(
        A.mult, B, b, M=lambda v: v / diag, rel_tol=1e-12, max_iter=6000)
    assert bool(ie.converged)
    scale = float(jnp.abs(xe).max())
    assert float(jnp.abs(B.mult(xe)).max()) < 1e-10 * scale
