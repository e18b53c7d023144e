"""Diffusion integrator, partial assembly.

Reference analog: ``DiffusionIntegrator`` (``fem/bilininteg.hpp:2177``); PA
setup ``PADiffusionSetup3D`` computes per-qpt
``D = (w/detJ) · adj(J) · C · adj(J)ᵀ``
(``fem/integ/bilininteg_diffusion_kernels.cpp:243-300``) and the apply is the
sum-factorized ``Gᵀ (D ∘ (G u))`` (``bilininteg_diffusion_kernels.hpp:796``).

Here qdata is the full symmetric (ne, nq, dim, dim) matrix (the reference
stores 6 packed entries; XLA fuses either way — packing is a later memory
optimization), and both scalar and matrix coefficients are supported.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fem.geom_factors import GeometricFactors, adjugate
from ..fem.quadinterp import (
    DeviceBasis,
    contract_q_to_e,
    eval_grad,
    eval_grad_t,
)


def setup(gf: GeometricFactors, coeff_q=None) -> jnp.ndarray:
    """qdata[e,q] = (w/detJ) adj(J) C adj(J)ᵀ → (ne, nq, dim, dim).

    ``coeff_q``: None (unit), (ne, nq) scalar, or (ne, nq, dim, dim) matrix
    conductivity.
    """
    A = adjugate(gf.jac)                               # (ne, nq, dim, dim)
    w_over_det = gf.w[None, :] / gf.det
    if coeff_q is not None and not hasattr(coeff_q, "ndim"):
        coeff_q = jnp.broadcast_to(
            jnp.asarray(coeff_q, A.dtype), gf.det.shape
        )
    if coeff_q is None:
        D = jnp.einsum("eqab,eqcb->eqac", A, A)
    elif coeff_q.ndim == 2:
        D = jnp.einsum("eqab,eqcb->eqac", A, A) * coeff_q[..., None, None]
        return D * w_over_det[..., None, None]
    else:
        D = jnp.einsum("eqab,eqbc,eqdc->eqad", A, coeff_q, A)
    return D * w_over_det[..., None, None]


def setup_packed(gf: GeometricFactors, coeff_q=None) -> jnp.ndarray:
    """Packed-symmetric qdata computed entirely elementwise → (3|6, ne, nq).

    Equivalent to ``pack_sym(setup(gf, coeff))`` for scalar coefficients but
    never emits a dot_general: the (ne, nq, d, d) intermediate of the
    einsum form never materializes — this elementwise form fuses away.
    """
    A = adjugate(gf.jac)                                # stacked elementwise
    w_over_det = gf.w[None, :] / gf.det
    if coeff_q is not None:
        if callable(coeff_q):
            coeff_q = jnp.asarray(coeff_q(gf.x), A.dtype)
        elif not hasattr(coeff_q, "ndim"):
            coeff_q = jnp.asarray(coeff_q, A.dtype)
        w_over_det = w_over_det * coeff_q
    d = A.shape[-1]

    def dot_rows(a, c):
        s = A[..., a, 0] * A[..., c, 0]
        for b in range(1, d):
            s = s + A[..., a, b] * A[..., c, b]
        return s * w_over_det

    if d == 2:
        return jnp.stack([dot_rows(0, 0), dot_rows(1, 1), dot_rows(0, 1)],
                         axis=0)
    return jnp.stack(
        [dot_rows(0, 0), dot_rows(1, 1), dot_rows(2, 2),
         dot_rows(0, 1), dot_rows(0, 2), dot_rows(1, 2)], axis=0
    )


def pack_sym(D: jnp.ndarray) -> jnp.ndarray:
    """(ne, nq, dim, dim) symmetric → packed (3|6, ne, nq):
    2D [D00, D11, D01]; 3D [D00, D11, D22, D01, D02, D12].

    Two wins (reference analog: the 6-entry symmetric storage of
    bilininteg_diffusion_kernels.cpp:243): 2/3 the memory traffic, and a
    layout whose trailing (ne, nq) dims are contiguous per component
    instead of a trailing (…, 3, 3)."""
    d = D.shape[-1]
    if d == 2:
        return jnp.stack([D[..., 0, 0], D[..., 1, 1], D[..., 0, 1]], axis=0)
    return jnp.stack(
        [D[..., 0, 0], D[..., 1, 1], D[..., 2, 2],
         D[..., 0, 1], D[..., 0, 2], D[..., 1, 2]], axis=0
    )


def _apply_packed(qd, g):
    """Packed symmetric D·g; qd (3|6, ne, nq), g (ne, nq, dim[, c])."""
    extra = g.ndim > 3
    def comp(i):
        return qd[i][..., None] if extra else qd[i]

    if qd.shape[0] == 3:      # 2D
        gx, gy = (g[..., 0, :], g[..., 1, :]) if extra else (g[..., 0], g[..., 1])
        Dx = comp(0) * gx + comp(2) * gy
        Dy = comp(2) * gx + comp(1) * gy
        return jnp.stack([Dx, Dy], axis=2 if extra else -1)
    gx, gy, gz = (
        (g[..., 0, :], g[..., 1, :], g[..., 2, :]) if extra
        else (g[..., 0], g[..., 1], g[..., 2])
    )
    Dx = comp(0) * gx + comp(3) * gy + comp(4) * gz
    Dy = comp(3) * gx + comp(1) * gy + comp(5) * gz
    Dz = comp(4) * gx + comp(5) * gy + comp(2) * gz
    return jnp.stack([Dx, Dy, Dz], axis=2 if extra else -1)


def _is_packed(qdata, dim):
    return qdata.ndim == 3 and qdata.shape[0] in (3, 6)


def apply(db: DeviceBasis, qdata: jnp.ndarray, u_e: jnp.ndarray) -> jnp.ndarray:
    """(ne, nd[, c]) → (ne, nd[, c]): Gᵀ (D · (G u)); accepts full (…,d,d)
    or packed symmetric qdata (see pack_sym)."""
    import jax

    with jax.named_scope("diffusion-apply"):
        g = eval_grad(db, u_e)                         # (ne, nq, dim[, c])
        if _is_packed(qdata, db.dim):
            Dg = _apply_packed(qdata, g)
        elif u_e.ndim > 2:
            Dg = jnp.einsum("eqab,eqb...->eqa...", qdata, g)
        else:
            Dg = jnp.einsum("eqab,eqb->eqa", qdata, g)
        return eval_grad_t(db, Dg)


def diagonal(db: DeviceBasis, qdata: jnp.ndarray) -> jnp.ndarray:
    """diag(Gᵀ D G) per element → (ne, nd).

    Tensor path: the (a,b) qdata component contributes a contraction whose
    1D factor along axis d is (G∘G) if d==a==b, (B∘G)/(G∘B) for the cross
    terms, (B∘B) otherwise (reference: AssembleDiagonalPA kernels in
    fem/integ/bilininteg_diffusion_kernels.hpp).
    """
    packed = _is_packed(qdata, db.dim)
    if packed:
        if qdata.shape[0] == 3:
            pidx = {(0, 0): 0, (1, 1): 1, (0, 1): 2, (1, 0): 2}
        else:
            pidx = {(0, 0): 0, (1, 1): 1, (2, 2): 2, (0, 1): 3, (1, 0): 3,
                    (0, 2): 4, (2, 0): 4, (1, 2): 5, (2, 1): 5}

        def comp(a, b):
            return qdata[pidx[(a, b)]]
    else:
        def comp(a, b):
            return qdata[:, :, a, b]

    if not db.tensor:
        if packed:
            out = None
            dim = db.dim
            for a in range(dim):
                for b in range(dim):
                    t = jnp.einsum(
                        "qn,eq,qn->en",
                        db.G[:, :, a], comp(a, b), db.G[:, :, b],
                    )
                    out = t if out is None else out + t
            return out
        return jnp.einsum("qna,eqab,qnb->en", db.G, qdata, db.G)
    B, G = db.B1, db.G1
    BB, BG, GG = B * B, B * G, G * G   # elementwise; B∘G == G∘B
    dim = db.dim
    out = None
    for a in range(dim):
        for b in range(dim):
            facs = []
            for d in range(dim):
                if d == a and d == b:
                    facs.append(GG)
                elif d == a or d == b:
                    facs.append(BG)
                else:
                    facs.append(BB)
            term = contract_q_to_e(tuple(facs), comp(a, b))
            out = term if out is None else out + term
    return out
