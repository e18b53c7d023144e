"""Hybridization for H(div) problems: face multipliers + batched local
elimination.

Reference analog: ``Hybridization`` (``fem/hybridization.hpp:62``, device
path ``fem/hybridization_ext.cpp``) — reduce an H(div) system to an SPD
interface problem in facet multipliers.

Formulation: the *broken* space is simply the E-vector (each
element owns private copies of its canonical face dofs), and inter-element
continuity is the linear constraint "the two copies of each interior face's
canonical dof agree" — a ±1 incidence matrix C, because the dofs are
already expressed in each face's canonical frame (fe_vector_simplex /
fe_vector_ho).  Hybridizing the SPD operator A (e.g. α(u,v)+β(div u,div v)):

    minimize ½ uᵀA_e u − bᵀu  over broken u,  s.t.  C u = 0
    ⇒  H λ = C A⁻¹ b,   H = C A⁻¹ Cᵀ  (SPD),   u = A⁻¹(b − Cᵀ λ)

with A block-diagonal per element: one batched Cholesky factorization
(batched triangular solves), then CG on the much smaller interface
system.  Essential (normal-trace) dofs are element-private boundary slots,
eliminated inside the blocks with the coupling moved to the RHS.

Unlike the slot-layout-dependent reference implementation, the constraint
is derived purely from the gather map: any canonical dof appearing in
exactly two (element, slot) pairs is an interior-face dof and gets one
multiplier.  This works unchanged for ``VectorSimplexSpace`` (tri/tet) and
the entity-keyed tensor ``RTSpaceHO`` (quad/hex) layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg.solvers import cg
from ..utils.config import real_t


def _canonical_elem_mats(op):
    """Per-element matrices in canonical dof values (Tᵀ A_e T)."""
    A_e = op._elem_mats()
    if op.tf is not None:
        A_e = jax.vmap(op.tft, in_axes=1, out_axes=1)(A_e)
        A_e = jax.vmap(op.tft, in_axes=2, out_axes=2)(A_e)
    else:
        A_e = A_e * op.signs[:, :, None] * op.signs[:, None, :]
    return A_e


def _elem_rhs(op, vec_fn):
    """Per-element RHS (f, φ) in canonical dofs (pre-scatter linear form)."""
    name, qd_mass, Bq = next(t for t in op.terms if t[0] == "mass")
    c = jnp.asarray(vec_fn(np.asarray(op.gf.x)), Bq.dtype)
    v = jnp.einsum("eqnc,eqc->en", Bq, op.gf.wdet[..., None] * c)
    return op._post(v)


@dataclasses.dataclass(eq=False)
class HybridizedHdiv:
    """Hybridized SPD H(div) solver state."""

    space: object
    op: object
    chol: jnp.ndarray             # (ne, ndl, ndl) Cholesky factors
    lam_elem: jnp.ndarray         # (ne, ndl) multiplier id per slot (or nlam)
    lam_sign: jnp.ndarray         # (ne, ndl) ±1 / 0
    nlam: int
    ess_mask: jnp.ndarray         # (ne, ndl) 0 at essential slots
    bc_vals: jnp.ndarray          # (ne, ndl) essential values
    bc_fix: jnp.ndarray           # (ne, ndl) A_canon @ ((1-m)·bc) correction

    def _Ainv(self, r):
        return jax.scipy.linalg.cho_solve((self.chol, True), r[..., None])[
            ..., 0
        ]

    def _CT(self, lam):
        """Multipliers → per-element vector (signed copies at face slots)."""
        lam1 = jnp.concatenate([lam, jnp.zeros(1, lam.dtype)])
        return lam1[self.lam_elem] * self.lam_sign

    def _C(self, u):
        """Per-element vector → jumps at interior faces."""
        vals = u * self.lam_sign
        flat = jnp.zeros(self.nlam + 1, u.dtype)
        flat = flat.at[self.lam_elem.reshape(-1)].add(vals.reshape(-1))
        return flat[: self.nlam]

    def solve(self, vec_fn, rel_tol=1e-10, max_iter=2000):
        """Solve A u = (f,φ) with continuity + essential BCs; returns
        (u_global, lam, SolveInfo of the interface CG)."""
        b = _elem_rhs(self.op, vec_fn)
        m = self.ess_mask
        b = (b - self.bc_fix) * m + self.bc_vals * (1 - m)

        Ainvb = self._Ainv(b)
        rhs = self._C(Ainvb)

        def H(lam):
            return self._C(self._Ainv(self._CT(lam)))

        lam, info = cg(H, rhs, rel_tol=rel_tol, max_iter=max_iter)
        u_e = self._Ainv(b - self._CT(lam))
        # assemble global (copies agree to solver tol → average)
        gm = self.op.gather
        ndof = self.op.ndof
        num = jnp.zeros(ndof, u_e.dtype).at[gm.reshape(-1)].add(
            u_e.reshape(-1))
        den = jnp.zeros(ndof, u_e.dtype).at[gm.reshape(-1)].add(
            jnp.ones_like(u_e).reshape(-1))
        return num / den, lam, info


def hybridize_hdiv(
    space,
    op,
    ess: Optional[np.ndarray] = None,
    bc_vals: Optional[jnp.ndarray] = None,
    dtype=None,
) -> HybridizedHdiv:
    """Build the hybridized solver for an SPD VecFEOperator on an RT space.

    ``space`` — RT space (``VectorSimplexSpace`` or ``RTSpaceHO``); ``op`` —
    the SPD VecFEOperator (mass [+ divdiv]).  ``ess`` — essential (normal
    trace) global dofs with optional values ``bc_vals`` (global vector)."""
    rt = real_t(dtype)
    gm = np.asarray(op.gather, dtype=np.int64)
    ne, ndl = gm.shape

    # interior-face dofs: canonical dof shared by exactly two (elem, slot)
    # pairs → one multiplier; constraint is copy₁ − copy₂ = 0.
    flat = gm.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    uniq, start, counts = np.unique(
        sorted_ids, return_index=True, return_counts=True)
    shared = uniq[counts == 2]
    nlam = len(shared)
    lam_of_dof = np.full(int(flat.max()) + 1, -1, dtype=np.int64)
    lam_of_dof[shared] = np.arange(nlam)
    lam_elem = lam_of_dof[gm]                         # (ne, ndl) or -1
    # sign: first occurrence (in sorted order) +1, second −1
    run = np.searchsorted(uniq, sorted_ids)
    occ = np.arange(len(flat)) - start[run]
    sign = np.zeros(len(flat))
    sign[order] = np.where(counts[run] == 2,
                           np.where(occ == 0, 1.0, -1.0), 0.0)
    lam_sign = sign.reshape(ne, ndl)
    lam_elem = np.where(lam_elem < 0, nlam, lam_elem)

    # canonical element matrices + essential elimination inside blocks
    A_canon = _canonical_elem_mats(op)
    ess = np.zeros(0, np.int64) if ess is None else np.asarray(ess)
    in_ess = np.isin(gm, ess)
    m = jnp.asarray(~in_ess, rt)                      # (ne, ndl)

    if bc_vals is not None:
        bc_e = jnp.asarray(np.asarray(bc_vals)[gm], rt)
    else:
        bc_e = jnp.zeros((ne, ndl), rt)
    # move BC coupling to the RHS before zeroing rows/cols
    bc_fix = jnp.einsum("enm,em->en", A_canon, bc_e * (1 - m))

    eye = jnp.eye(ndl, dtype=A_canon.dtype)
    A_canon = (A_canon * m[:, :, None] * m[:, None, :]
               + eye[None] * (1 - m)[:, :, None])
    chol = jnp.linalg.cholesky(A_canon)

    return HybridizedHdiv(
        space=space, op=op, chol=chol,
        lam_elem=jnp.asarray(lam_elem), lam_sign=jnp.asarray(lam_sign, rt),
        nlam=nlam, ess_mask=m, bc_vals=bc_e, bc_fix=bc_fix,
    )
