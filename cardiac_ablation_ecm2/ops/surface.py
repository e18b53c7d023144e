"""Surface (Laplace–Beltrami) operators on embedded meshes.

Reference analog: ``examples/ex7.cpp`` — DiffusionIntegrator on a mesh
with dim < sdim, where MFEM's element transformations produce the
pseudo-inverse Jacobian.  Design: the weak tangential gradient is a
*reference-space* quadratic form,

    ∫_S ∇_S u · ∇_S v = Σ_q w_q √det G  (∇̂u)ᵀ G⁻¹ (∇̂v),   G = JᵀJ,

so the standard packed-symmetric diffusion apply works unchanged with
qdata = wdet · G⁻¹ — no pseudo-inverses in the hot loop."""

from __future__ import annotations

import jax.numpy as jnp

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.geom_factors import GeometricFactors
from . import diffusion as dmod
from . import mass as mmod


def setup_surface_diffusion(gf: GeometricFactors, coeff=None) -> jnp.ndarray:
    """Packed-symmetric (3|1, ne, nq) qdata wdet·G⁻¹ for a surface mesh."""
    J = gf.jac                                   # (ne, nq, sdim, dim)
    G = jnp.einsum("eqsa,eqsb->eqab", J, J)      # metric (dim, dim)
    dim = G.shape[-1]
    w = gf.wdet
    if coeff is not None:
        w = w * coeff
    if dim == 1:
        D = (w / G[..., 0, 0])[..., None, None]
    else:
        detG = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
        inv = jnp.stack([
            jnp.stack([G[..., 1, 1], -G[..., 0, 1]], axis=-1),
            jnp.stack([-G[..., 1, 0], G[..., 0, 0]], axis=-1),
        ], axis=-2) / detG[..., None, None]
        D = w[..., None, None] * inv
    return dmod.pack_sym(D)


def surface_operators(fes, diffusion_coeff=None, mass_coeff=None,
                      nq1d=None, dtype=None):
    """(mult, diagonal) closures for α(∇_S u, ∇_S v) + β(u, v) on an
    embedded surface FESpace."""
    gf = geom_factors_for(fes, nq1d, dtype)
    db = basis_for(fes, nq1d, dtype)
    restr = restriction_for(fes)
    qd_k = (None if diffusion_coeff is None
            else setup_surface_diffusion(gf, diffusion_coeff))
    qd_m = None
    if mass_coeff is not None:
        qd_m = mmod.setup(gf)
        qd_m = qd_m * mass_coeff

    def mult(x):
        e = restr.mult(x)
        acc = None
        if qd_k is not None:
            acc = dmod.apply(db, qd_k, e)
        if qd_m is not None:
            t = mmod.apply(db, qd_m, e)
            acc = t if acc is None else acc + t
        return restr.mult_transpose(acc)

    def diagonal():
        acc = None
        if qd_k is not None:
            acc = dmod.diagonal(db, qd_k)
        if qd_m is not None:
            t = mmod.diagonal(db, qd_m)
            acc = t if acc is None else acc + t
        return restr.mult_transpose(acc)

    return mult, diagonal
