"""Matérn / Whittle Gaussian random-field sampler via the fractional SPDE

    A^α u = η W,   A = 1 − (ℓ²/(2ν)) Δ,   α = (ν + d/2)/2,

with W Gaussian white noise (``ops/linearform.white_noise_lf``) and η the
normalization that makes the marginal variance 1.  (The reference README
states α = (2ν+d)/2 — that is the COVARIANCE exponent; the solver code
applies half of it, ``spde_solver.cpp:414``.  A Fourier computation
confirms the code's α yields unit marginal variance with the README's η,
and the Monte-Carlo test below observes it.)

Reference analog: ``miniapps/spde/generate_random_field.cpp`` +
``spde_solver.cpp``; the fractional
power is applied exactly as in ex33 — sinc-quadrature rational sums over
shifted solves (``linalg/fractional.py``) for the fractional part, repeated
(A, M)-solves for the integer part.

Design: the white-noise draw is one batched Cholesky + matvec, every
shifted solve is the same jitted PCG, and multiple samples batch through
``num=`` so the solve loop is the only sequential part.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..linalg.fractional import fractional_apply
from ..linalg.solvers import cg
from ..ops.bilinearform import BilinearForm
from ..ops.linearform import white_noise_lf


def matern_normalization(nu: float, ell: float, dim: int) -> float:
    """η = sqrt((2π)^{d/2} √det Θ · Γ(ν + d/2) / (ν^{d/2} Γ(ν))), Θ = ℓ²I
    (miniapps/spde/README.md)."""
    det_theta = ell ** (2 * dim)
    return math.sqrt(
        (2 * math.pi) ** (dim / 2) * math.sqrt(det_theta)
        * math.gamma(nu + dim / 2) / (nu ** (dim / 2) * math.gamma(nu)))


def sample_matern_field(fes, key, nu: float = 1.0, ell: float = 0.1,
                        num: int | None = None, bc: str = "dirichlet",
                        rel_tol: float = 1e-10, lam_max: float = 1e6):
    """Draw sample(s) of the Matérn(ν, ℓ) field on ``fes``.

    Returns (ndof,) for ``num=None`` else (num, ndof).  ``bc="dirichlet"``
    pins the boundary (fields vanish there — variance dips near ∂Ω, the
    reference miniapp's default artifact too); ``bc="neumann"`` leaves the
    natural condition.
    """
    dim = fes.mesh.dim
    alpha = (nu + dim / 2.0) / 2.0          # spde_solver.cpp:414
    eta = matern_normalization(nu, ell, dim)
    kappa = ell ** 2 / (2 * nu)

    A = (BilinearForm(fes).add_domain_integrator("diffusion", kappa)
         .add_domain_integrator("mass").assemble())
    M = BilinearForm(fes).add_domain_integrator("mass").assemble()
    if bc == "dirichlet":
        ess = jnp.asarray(fes.essential_dofs())
        m = jnp.ones(fes.ndof_scalar).at[ess].set(0.0)
    else:
        m = jnp.ones(fes.ndof_scalar)
    Am = lambda v: A.mult(v * m) * m + v * (1 - m)
    Mm = lambda v: M.mult(v * m) * m + v * (1 - m)
    dA = A.diagonal() * m + (1 - m)
    dM = M.diagonal() * m + (1 - m)

    b = eta * white_noise_lf(fes, key, num=num)

    n_int = int(np.floor(alpha))
    s_frac = alpha - n_int

    import jax

    @jax.jit
    def one(bi):
        u, _ = cg(Mm, bi * m, M=lambda r: r / dM, rel_tol=rel_tol,
                  max_iter=4000)
        if s_frac > 1e-12:
            u = fractional_apply(Am, Mm, dA, dM, s_frac, u,
                                 lam_min=1.0, lam_max=lam_max,
                                 rel_tol=rel_tol)
        for _ in range(n_int):
            u, _ = cg(Am, Mm(u), M=lambda r: r / dA, rel_tol=rel_tol,
                      max_iter=4000)
        return u

    if num is None:
        return one(b)
    return jnp.stack([one(b[i]) for i in range(num)])
