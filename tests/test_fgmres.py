"""FGMRES (variable preconditioner) + OrthoSolver (constant-nullspace)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.linalg.krylov_extra import fgmres, ortho_wrap
from cardiac_ablation_ecm2.linalg.solvers import cg


def _system(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) * 0.3   # nonsymmetric
    b = rng.standard_normal(n)
    return jnp.asarray(A), jnp.asarray(b), np.linalg.solve(A, b)


def test_fgmres_plain():
    A, b, xref = _system()
    x, info = fgmres(lambda v: A @ v, b, rel_tol=1e-12, restart=20,
                     max_iter=200)
    assert bool(info.converged)
    assert np.abs(np.asarray(x) - xref).max() < 1e-8


def test_fgmres_variable_preconditioner():
    """Inner-iteration preconditioner (a few Jacobi sweeps whose effective
    operator varies with the input) — exactly what FGMRES tolerates and
    standard GMRES does not guarantee."""
    A, b, xref = _system(seed=3)
    d = jnp.diag(A)
    state = {"k": 0}

    def M(v):
        # deliberately non-constant: alternates sweep counts
        state["k"] += 1
        sweeps = 1 + (state["k"] % 3)
        z = v / d
        for _ in range(sweeps):
            z = z + (v - A @ z) / d
        return z

    x, info = fgmres(lambda v: A @ v, b, M=M, rel_tol=1e-12, restart=20,
                     max_iter=200)
    assert bool(info.converged)
    assert np.abs(np.asarray(x) - xref).max() < 1e-8


def test_ortho_singular_neumann():
    """Singular SPD system (1D Neumann Laplacian): CG with the constant
    nullspace projected out converges to the mean-zero solution."""
    n = 30
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 2.0
        if i > 0:
            A[i, i - 1] = -1.0
        if i < n - 1:
            A[i, i + 1] = -1.0
    A[0, 0] = A[-1, -1] = 1.0                     # Neumann ends: A·1 = 0
    A = jnp.asarray(A)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    b = jnp.asarray(b - b.mean())                 # compatible RHS

    Aop = ortho_wrap(lambda v: A @ v)
    x, info = cg(Aop, b - jnp.mean(b), rel_tol=1e-12, max_iter=500)
    assert bool(info.converged)
    assert abs(float(jnp.mean(x))) < 1e-10
    r = np.array(A @ x - b)
    r = r - r.mean()
    assert np.abs(r).max() < 1e-8
