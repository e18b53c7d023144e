"""Constrained linear solvers: A x = f subject to B x = r.

Reference analog: ``linalg/constraints.hpp`` — ``ConstrainedSolver`` and its
three strategies (``EliminationSolver``, ``PenaltyConstrainedSolver``,
``SchurConstrainedSolver``) plus the ``BuildNormalConstraints`` helper used
by ``examples/ex28.cpp`` (sliding boundary conditions).

Design
-----------------
The reference eliminates constraints by reordering a CSR matrix into
primary/secondary dof blocks (``linalg/constraints.cpp``); there is no
assembled matrix here, so all three strategies are built on matrix-free
callables and a *padded sparse* constraint operator:

* ``Constraints`` stores B as ``(m, kmax)`` index/value lanes — ``B v`` is a
  gather-dot, ``Bᵀ λ`` a scatter-add; both jit/shard-map friendly with
  static shapes.
* Elimination becomes *projection*: P = I − Bᵀ(BBᵀ)⁻¹B applied around the
  operator and preconditioner (the same masked-identity trick the essential
  BCs use), with the small Gram matrix BBᵀ Cholesky-factored once at setup
  on the host and ``cho_solve``d on device.  Constraint blocks never touch
  the hot loop.
* Penalty and Schur (MINRES on the saddle-point block vector) mirror the
  reference's other two strategies for cross-checking and for rank-deficient
  or inexact-constraint cases.

All solves return ``(x, lam, SolveInfo)`` where ``lam`` is the Lagrange
multiplier (``GetMultiplierSolution`` analog).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg
import numpy as np

from .krylov_extra import minres
from .solvers import SolveInfo, cg, default_dot


@dataclass(frozen=True)
class Constraints:
    """Padded-sparse constraint matrix B (m × n).

    ``idx[i, k]`` / ``val[i, k]`` — the k-th (column, coefficient) entry of
    row i; padding entries have ``val == 0`` (their ``idx`` is an arbitrary
    valid column).  ``rowstarts`` groups rows into physical constraint
    blocks exactly like the reference's ``constraint_rowstarts``
    (constraints.hpp:525): block b spans rows
    ``rowstarts[b]:rowstarts[b+1]``.
    """

    idx: jnp.ndarray          # (m, kmax) int32
    val: jnp.ndarray          # (m, kmax)
    n: int                    # column count (= dof count)
    rowstarts: np.ndarray     # (nblocks + 1,) host-side block structure

    @property
    def m(self) -> int:
        return int(self.idx.shape[0])

    def mult(self, v: jnp.ndarray) -> jnp.ndarray:
        """B v — one gather-dot per row."""
        return (v[self.idx] * self.val).sum(axis=1)

    def mult_t(self, lam: jnp.ndarray) -> jnp.ndarray:
        """Bᵀ λ — scatter-add of the row entries."""
        return jnp.zeros(self.n, lam.dtype).at[self.idx].add(
            self.val * lam[:, None])

    def select_rows(self, rows: np.ndarray) -> "Constraints":
        """Host-side row subset (used by active-set contact loops)."""
        rows = np.asarray(rows)
        return Constraints(
            idx=self.idx[rows], val=self.val[rows], n=self.n,
            rowstarts=np.arange(len(rows) + 1))

    def gram_cholesky(self) -> np.ndarray:
        """Host Cholesky factor of G = B Bᵀ (m × m, setup-time only)."""
        import scipy.sparse as sp

        idx = np.asarray(self.idx)
        val = np.asarray(self.val)
        m, kmax = idx.shape
        rows = np.repeat(np.arange(m), kmax)
        B = sp.csr_matrix((val.ravel(), (rows, idx.ravel())),
                          shape=(m, self.n))
        G = np.asarray((B @ B.T).todense())
        # tiny shift guards duplicated/near-dependent rows
        G[np.diag_indices_from(G)] += 1e-14 * max(G.diagonal().max(), 1.0)
        return np.linalg.cholesky(G)


def from_rows(rows, n: int, rowstarts=None, dtype=jnp.float32) -> Constraints:
    """Build ``Constraints`` from a list of rows, each a list of
    ``(column, coefficient)`` pairs."""
    kmax = max((len(r) for r in rows), default=1)
    m = len(rows)
    idx = np.zeros((m, kmax), np.int32)
    val = np.zeros((m, kmax), np.float64)
    for i, r in enumerate(rows):
        for k, (j, c) in enumerate(r):
            idx[i, k] = j
            val[i, k] = c
    if rowstarts is None:
        rowstarts = np.arange(m + 1)
    return Constraints(idx=jnp.asarray(idx), val=jnp.asarray(val, dtype),
                       n=n, rowstarts=np.asarray(rowstarts))


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def penalty_constrained_solve(
    Amult: Callable, B: Constraints, f: jnp.ndarray,
    r: Optional[jnp.ndarray] = None, penalty: float = 1e8,
    M: Optional[Callable] = None, rel_tol: float = 1e-10,
    max_iter: int = 2000, dot: Callable = default_dot,
) -> Tuple[jnp.ndarray, jnp.ndarray, SolveInfo]:
    """PenaltyConstrainedSolver analog (constraints.hpp:319): CG on
    A + p BᵀB with rhs f + p Bᵀ r; λ ≈ p (B x − r)."""
    rr = jnp.zeros(B.m, f.dtype) if r is None else jnp.asarray(r, f.dtype)

    def Ap(v):
        return Amult(v) + penalty * B.mult_t(B.mult(v))

    x, info = cg(Ap, f + penalty * B.mult_t(rr), M=M, rel_tol=rel_tol,
                 max_iter=max_iter, dot=dot)
    lam = penalty * (B.mult(x) - rr)
    return x, lam, info


def eliminate_constrained_solve(
    Amult: Callable, B: Constraints, f: jnp.ndarray,
    r: Optional[jnp.ndarray] = None, M: Optional[Callable] = None,
    rel_tol: float = 1e-10, max_iter: int = 2000,
    dot: Callable = default_dot, chol: Optional[np.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, SolveInfo]:
    """EliminationCGSolver analog (constraints.hpp:260) as *projected* CG.

    With P = I − Bᵀ(BBᵀ)⁻¹B the orthogonal projector onto null(B) and
    x_p = Bᵀ(BBᵀ)⁻¹ r the minimum-norm particular solution, solve

        (P A P + (I − P)) y = P (f − A x_p),     x = x_p + y.

    The identity on range(Bᵀ) keeps the operator SPD on the whole space —
    the exact pattern the essential-BC masking uses, so CG needs no special
    handling.  λ = (BBᵀ)⁻¹ B (f − A x).
    """
    L = jnp.asarray(B.gram_cholesky() if chol is None else chol, f.dtype)

    def Ginv(y):
        return jsp_linalg.cho_solve((L, True), y)

    def proj(v):
        return v - B.mult_t(Ginv(B.mult(v)))

    xp = (B.mult_t(Ginv(jnp.asarray(r, f.dtype)))
          if r is not None else jnp.zeros_like(f))

    def Ac(v):
        pv = proj(v)
        return proj(Amult(pv)) + (v - pv)

    Mc = None
    if M is not None:
        def Mc(v):  # noqa: E306
            pv = proj(v)
            return proj(M(pv)) + (v - pv)

    y, info = cg(Ac, proj(f - Amult(xp)), M=Mc, rel_tol=rel_tol,
                 max_iter=max_iter, dot=dot)
    x = xp + proj(y)
    lam = Ginv(B.mult(f - Amult(x)))
    return x, lam, info


def schur_constrained_solve(
    Amult: Callable, B: Constraints, f: jnp.ndarray,
    r: Optional[jnp.ndarray] = None, Adiag: Optional[jnp.ndarray] = None,
    rel_tol: float = 1e-10, max_iter: int = 4000,
    dot: Callable = default_dot,
) -> Tuple[jnp.ndarray, jnp.ndarray, SolveInfo]:
    """SchurConstrainedSolver analog (constraints.hpp:450): MINRES on the
    saddle-point block system with a block-diagonal preconditioner
    (diag(A)⁻¹, [B diag(A)⁻¹ Bᵀ]-diagonal⁻¹ — the reference's own choice)."""
    n, m = B.n, B.m
    rr = jnp.zeros(m, f.dtype) if r is None else jnp.asarray(r, f.dtype)

    def K(z):
        x, lam = z[:n], z[n:]
        return jnp.concatenate([Amult(x) + B.mult_t(lam), B.mult(x)])

    dA = jnp.ones(n, f.dtype) if Adiag is None else jnp.asarray(Adiag, f.dtype)
    # diag(B diag(A)⁻¹ Bᵀ) computed row-wise on the padded lanes
    dS = (B.val * B.val / dA[B.idx]).sum(axis=1)
    dS = jnp.where(dS > 0, dS, 1.0)

    def prec(z):
        return jnp.concatenate([z[:n] / dA, z[n:] / dS])

    z, info = minres(K, jnp.concatenate([f, rr]), M=prec, rel_tol=rel_tol,
                     max_iter=max_iter, dot=dot)
    return z[:n], z[n:], info


# ---------------------------------------------------------------------------
# constraint builders (host, setup-time)
# ---------------------------------------------------------------------------

def boundary_face_normals(mesh) -> np.ndarray:
    """Outward unit normal per boundary face, from the face vertices
    (flat-face/first-order geometry; the quadrature-point variant lives in
    ``ops/linearform.boundary_normal_lf``)."""
    V = mesh.vertices
    bf = mesh.boundary
    if mesh.dim == 2:
        t = V[bf[:, 1]] - V[bf[:, 0]]
        n = np.stack([t[:, 1], -t[:, 0]], axis=-1)
    else:
        e1 = V[bf[:, 1]] - V[bf[:, 0]]
        e2 = V[bf[:, -1]] - V[bf[:, 0]]
        n = np.cross(e1, e2)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    # orient outward: against the adjacent element centroid
    vmap = {}
    for e in range(mesh.ne):
        for v in mesh.elements[e]:
            vmap.setdefault(int(v), []).append(e)
    cent = V[mesh.elements].mean(axis=1)
    fcent = V[bf].mean(axis=1)
    for fi in range(mesh.nbe):
        fset = set(int(v) for v in bf[fi])
        elem = None
        for c in vmap.get(int(bf[fi, 0]), []):
            if fset.issubset(set(int(v) for v in mesh.elements[c])):
                elem = c
                break
        if elem is None:
            elem = vmap[int(bf[fi, 0])][0]
        if np.dot(n[fi], fcent[fi] - cent[elem]) < 0:
            n[fi] = -n[fi]
    return n


def build_normal_constraints(
    fes, constrained_att, dtype=jnp.float32,
) -> Constraints:
    """BuildNormalConstraints analog (constraints.hpp:549): one row per
    (boundary node, attribute) constraining the normal displacement to zero
    on a vector H1 space with byNODES component layout.

    Nodes shared by several constrained attributes get one row per
    attribute, grouped into a single block (free along the intersection
    line in 3D; fully fixed at a 2D corner) — matching the reference's
    combining behavior.
    """
    mesh = fes.mesh
    ns = fes.ndof_scalar
    vdim = fes.vdim
    fn = boundary_face_normals(mesh)
    gmap = np.asarray(fes.bdr_gather_map)          # (nbe, ndf) scalar dofs
    # area weights per face for the normal average
    V = mesh.vertices
    bf = mesh.boundary
    if mesh.dim == 2:
        area = np.linalg.norm(V[bf[:, 1]] - V[bf[:, 0]], axis=-1)
    else:
        area = np.linalg.norm(
            np.cross(V[bf[:, 1]] - V[bf[:, 0]], V[bf[:, -1]] - V[bf[:, 0]]),
            axis=-1)

    att = np.asarray(mesh.bdr_attributes)
    want = set(int(a) for a in constrained_att)
    # node -> {attr: accumulated normal}
    acc: dict = {}
    for fi in range(mesh.nbe):
        a = int(att[fi])
        if a not in want:
            continue
        for d in gmap[fi]:
            acc.setdefault(int(d), {}).setdefault(a, np.zeros(mesh.dim))
            acc[int(d)][a] += area[fi] * fn[fi]

    rows, starts = [], [0]
    for d in sorted(acc):
        block = []
        for a in sorted(acc[d]):
            nrm = acc[d][a]
            nn = np.linalg.norm(nrm)
            if nn < 1e-14:
                continue
            nrm = nrm / nn
            # Gram-Schmidt against earlier rows of this block; drop
            # near-parallel duplicates (the reference warns about this case)
            for prev in block:
                nrm = nrm - np.dot(nrm, prev) * prev
            nn = np.linalg.norm(nrm)
            if nn < 1e-8:
                continue
            block.append(nrm / nn)
        for nrm in block:
            rows.append([(d + c * ns, float(nrm[c])) for c in range(vdim)])
        starts.append(len(rows))
    return from_rows(rows, fes.ndof, rowstarts=np.asarray(starts),
                     dtype=dtype)
