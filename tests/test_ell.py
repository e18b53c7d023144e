"""ELL weighted-gather SpMV (ops/ell.py): cross-check vs scipy CSR and vs
the matrix-free PA path on p1 simplex meshes (the scatter-bound case it
exists for; reference SparseMatrix::Mult, linalg/sparsemat.cpp)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.smoothers import jacobi
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import (make_cartesian_2d_tri,
                                            make_cartesian_3d_tet)
from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator
from cardiac_ablation_ecm2.ops.ell import ELLOperator


def _check_mult(fes, kind, rtol=1e-6):
    a = BilinearForm(fes).add_domain_integrator(kind)
    A_csr = a.assemble_matrix("float64")
    ell = a.assemble_ell("float64")
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.standard_normal(fes.ndof)
        y_ref = A_csr @ x
        y = np.asarray(ell.mult(jnp.asarray(x)))
        np.testing.assert_allclose(y, y_ref, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ell.diagonal()),
                               A_csr.diagonal(), rtol=rtol)


def test_ell_matches_csr_tet_p1():
    fes = FESpace(make_cartesian_3d_tet(4, 4, 4), 1)
    _check_mult(fes, "mass")
    _check_mult(fes, "diffusion")


def test_ell_matches_csr_tri_p1():
    fes = FESpace(make_cartesian_2d_tri(6, 6), 1)
    _check_mult(fes, "diffusion")


def test_ell_matches_csr_tet_p2():
    # not the target regime, but the layout must stay correct at any order
    fes = FESpace(make_cartesian_3d_tet(3, 3, 3), 2)
    _check_mult(fes, "diffusion")


def test_ell_poisson_solve_matches_pa():
    """CG through the ELL operator reproduces the PA-path Poisson solve."""
    fes = FESpace(make_cartesian_3d_tet(4, 4, 4), 1)
    ess = fes.essential_dofs()
    b = jnp.ones(fes.ndof, dtype=jnp.float64)

    def solve(op):
        A = ConstrainedOperator.wrap(op, ess)
        B = A.eliminate_rhs(jnp.zeros_like(b), b)
        x, info = cg(A.mult, B, M=jacobi(A.diagonal()),
                     rel_tol=1e-12, max_iter=500)
        return np.asarray(x), int(info.iterations)

    a = BilinearForm(fes).add_domain_integrator("diffusion")
    x_pa, it_pa = solve(a.assemble().operator())
    x_ell, it_ell = solve(a.assemble_ell("float64").operator())
    np.testing.assert_allclose(x_ell, x_pa, rtol=1e-8, atol=1e-12)
    assert abs(it_ell - it_pa) <= 1
