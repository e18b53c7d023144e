"""Topology optimization: SIMP compliance minimization.

Reference analog: ``examples/ex37.cpp`` — elasticity compliance
minimization with volume constraint (there by proximal Galerkin; here the
classic SIMP + optimality-criteria loop of the 88-line topopt codes,
which the reference's miniapps also reference).

Design: the density enters as per-quadrature (λ_q, μ_q) scalings of
the existing elasticity PA kernel; element compliances come from the same
quadrature energy densities; the density filter is a sparse neighbor
average built once host-side.  Every solve/energy/update step is batched
jnp."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.fespace import FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad
from ..linalg.solvers import cg
from ..ops import elasticity as emod
from ..ops.linearform import boundary_lf_vector
from ..utils.config import real_t


@dataclasses.dataclass(eq=False)
class TopOpt:
    """Cantilever-style compliance minimization  min f·u(ρ)  s.t.
    Σ ρ_e v_e ≤ V̄,  ρ ∈ [ρ_min, 1]."""

    mesh: object
    order: int = 1
    volfrac: float = 0.4
    simp_p: float = 3.0
    E_min: float = 1e-4
    lam0: float = 1.0
    mu0: float = 1.0
    fixed_bdr: Sequence[int] = (4,)
    force_bdr: Sequence[int] = (2,)
    force: Sequence[float] = (0.0, -1.0)
    filter_radius: float = 0.0          # physical radius; 0 = no filter
    rel_tol: float = 1e-9
    max_iter: int = 2000
    dtype: object = None

    def __post_init__(self):
        mesh = self.mesh
        dim = mesh.dim
        rt = real_t(self.dtype)
        self.dim = dim
        self.fes = FESpace(mesh, self.order, vdim=dim)
        self.gf = geom_factors_for(self.fes, dtype=self.dtype)
        self.db = basis_for(self.fes, dtype=self.dtype)
        self.restr = restriction_for(self.fes)
        self._adj = adjugate(self.gf.jac)
        self.vol_e = jnp.sum(self.gf.wdet, axis=1)       # (ne,)

        ess_s = self.fes.essential_dofs(self.fixed_bdr)
        ns = self.fes.ndof_scalar
        ess = np.concatenate([ess_s + c * ns for c in range(dim)])
        mask = np.ones(self.fes.ndof)
        mask[ess] = 0.0
        self.mask = jnp.asarray(mask, rt)
        self.b = boundary_lf_vector(
            self.fes, np.asarray(self.force, dtype=np.float64),
            bdr_marker=self.force_bdr, dtype=self.dtype) * self.mask

        # density filter: neighbor average by centroid distance
        if self.filter_radius > 0:
            from scipy.spatial import cKDTree

            cent = mesh.vertices[mesh.elements].mean(axis=1)
            tree = cKDTree(cent)
            pairs = tree.query_ball_point(cent, self.filter_radius)
            rows, cols, w = [], [], []
            for i, nb in enumerate(pairs):
                dists = np.linalg.norm(cent[nb] - cent[i], axis=1)
                wt = self.filter_radius - dists
                wt = wt / wt.sum()
                rows += [i] * len(nb)
                cols += list(nb)
                w += list(wt)
            import scipy.sparse as sp

            self._filter = sp.csr_matrix(
                (w, (rows, cols)), shape=(mesh.ne, mesh.ne))
        else:
            self._filter = None

    # ------------------------------------------------------------------
    def _qdata(self, rho):
        scale = self.E_min + (1 - self.E_min) * rho ** self.simp_p  # (ne,)
        sq = scale[:, None] * jnp.ones_like(self.gf.det)
        return emod.setup(self.gf, self.lam0 * sq, self.mu0 * sq)

    def _solve(self, rho, u0=None):
        qd = self._qdata(rho)
        m = self.mask

        def A(v):
            # component-major flat → (ne, nd, vdim) E-vector
            comps = [self.restr.mult(
                (v * m)[c * self.fes.ndof_scalar:(c + 1)
                        * self.fes.ndof_scalar])
                for c in range(self.dim)]
            e = jnp.stack(comps, axis=-1)
            y_e = emod.apply(self.db, qd, e)
            outs = [self.restr.mult_transpose(y_e[..., c])
                    for c in range(self.dim)]
            y = jnp.concatenate(outs)
            return y * m + (v - v * m)

        d = emod.diagonal(self.db, qd)
        dg = jnp.concatenate(
            [self.restr.mult_transpose(d[..., c])
             for c in range(self.dim)])
        dg = dg * m + (1 - m)
        u, info = cg(A, self.b, x0=u0, M=lambda r: r / dg,
                     rel_tol=self.rel_tol, max_iter=self.max_iter)
        return u, info

    def _element_energies(self, rho, u):
        """Φ_e = ∫_e λ̃ tr(ε)²/2·2? — the compliance density u·K_e(ρ=1)u
        per element (for the SIMP sensitivity)."""
        ns = self.fes.ndof_scalar
        comps = [self.restr.mult(u[c * ns:(c + 1) * ns])
                 for c in range(self.dim)]
        e = jnp.stack(comps, axis=-1)
        g = eval_grad(self.db, e)                        # (ne,nq,dim,vdim)
        H = jnp.einsum("eqsa,eqsc->eqac", self._adj, g) \
            / self.gf.det[..., None, None]               # ∇u physical
        epsil = 0.5 * (H + jnp.swapaxes(H, 2, 3))
        tr = jnp.einsum("eqaa->eq", epsil)
        dens = (0.5 * self.lam0 * tr ** 2
                + self.mu0 * jnp.einsum("eqab,eqab->eq", epsil, epsil))
        return 2.0 * jnp.sum(self.gf.wdet * dens, axis=1)   # u·K₁,e·u

    def step(self, rho, u0=None, move=0.2, rho_min=1e-3):
        """One OC update; returns (rho_new, u, compliance)."""
        u, _ = self._solve(rho, u0)
        compliance = float(self.b @ u)
        UKU = self._element_energies(rho, u)
        dC = -self.simp_p * (1 - self.E_min) \
            * rho ** (self.simp_p - 1) * UKU              # < 0
        if self._filter is not None:
            dC = jnp.asarray(self._filter @ np.asarray(dC * rho)) \
                / jnp.maximum(rho, rho_min)
        # optimality criteria with bisection on the volume multiplier
        vol_target = self.volfrac * float(self.vol_e.sum())
        lo, hi = 1e-12, 1e12
        for _ in range(60):
            lam = np.sqrt(lo * hi)
            Be = jnp.sqrt(jnp.maximum(-dC / (lam * self.vol_e), 0.0))
            cand = jnp.clip(rho * Be, jnp.maximum(rho - move, rho_min),
                            jnp.minimum(rho + move, 1.0))
            if float(self.vol_e @ cand) > vol_target:
                lo = lam
            else:
                hi = lam
        return cand, u, compliance

    def optimize(self, n_iter=30, rho0=None, verbose=False):
        rho = (jnp.full(self.mesh.ne, self.volfrac)
               if rho0 is None else rho0)
        u = None
        hist = []
        for it in range(n_iter):
            rho, u, c = self.step(rho, u)
            hist.append(c)
            if verbose:
                print(f"it {it}: compliance {c:.6f} "
                      f"vol {float(self.vol_e @ rho):.4f}")
        return rho, u, hist
