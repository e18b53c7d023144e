"""DG advection operator with upwind fluxes — the ex9 capability.

Reference analog: ``examples/ex9.cpp`` FE_Evolution (SURVEY.md §3.5):
volume ``ConvectionIntegrator`` + interior/boundary ``DGTraceIntegrator``
face terms + local DG mass inverse (``fem/dgmassinv.cpp``).

Semidiscrete form on an L2 space (weak form, integrating by parts):

    M du/dt = ∫ u (v·∇w) dx − ∮ F*(u⁻, u⁺, n) w dS,  F* = (v·n)·upwind(u)

Design: volume term = transpose-convection einsums; face terms = batched
per-face matmuls with precomputed side bases (``fem/faces.py``) + segment-sum
scatter back to elements; mass inverse = precomputed batched (nd×nd) inverses
(block-diagonal L2 mass) applied as one batched matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for
from ..fem.faces import build_face_data
from ..fem.fespace import L2FESpace
from ..fem.geom_factors import adjugate
from ..fem.quadinterp import eval_grad_t, eval_values
from ..utils.config import index_t, real_t
from . import mass as mmod


@dataclasses.dataclass(eq=False)
class DGAdvection:
    """y(u) = M⁻¹ (K u + F(u) + b_inflow); jit-safe TimeDependentOperator."""

    fes: L2FESpace
    velocity: Callable                     # v(x) -> (..., dim)
    inflow: Optional[Callable] = None      # boundary value g(x)
    nq1d: Optional[int] = None
    dtype: object = None

    def __post_init__(self):
        fes, mesh = self.fes, self.fes.mesh
        rt = real_t(self.dtype)
        self.db = basis_for(fes, self.nq1d, self.dtype)
        gf = geom_factors_for(fes, self.nq1d, self.dtype)

        # volume qdata: w · adj(J) v (transpose-convection)
        vq = jnp.asarray(self.velocity(gf.x), rt)
        A = adjugate(gf.jac)
        self.vol_qd = jnp.einsum("eqba,eqa->eqb", A, vq) * gf.w[None, :, None]

        # block-diagonal mass inverse (DGMassInverse analog)
        d2q = fes.d2q if self.nq1d is None else fes.dof_to_quad(self.nq1d)
        B = d2q.full_B()
        qd = np.asarray(mmod.setup(gf))
        Me = np.einsum("qm,eq,qn->emn", B, qd, B)
        self.Minv = jnp.asarray(np.linalg.inv(Me), rt)

        # face data
        fd = build_face_data(mesh, fes.order, self.nq1d)
        self.e0 = jnp.asarray(fd.elem0, index_t())
        self.e1 = jnp.asarray(fd.elem1, index_t())
        self.B0 = jnp.asarray(fd.B0, rt)
        self.B1 = jnp.asarray(fd.B1, rt)
        vn0 = np.einsum(
            "fqd,fqd->fq", np.asarray(self.velocity(fd.xq)), fd.normal
        )
        self.vn = jnp.asarray(vn0 * fd.wdet, rt)       # (nfi, nq_f) v·n dS

        self.be = jnp.asarray(fd.b_elem, index_t())
        self.bB = jnp.asarray(fd.b_B, rt)
        bvn = np.einsum(
            "fqd,fqd->fq", np.asarray(self.velocity(fd.b_xq)), fd.b_normal
        )
        self.bvn = jnp.asarray(bvn * fd.b_wdet, rt)
        if self.inflow is not None:
            self.g_in = jnp.asarray(self.inflow(fd.b_xq), rt)  # (nfb, nq_f)
        else:
            self.g_in = jnp.zeros_like(self.bvn)
        self.ne = mesh.ne

    # ------------------------------------------------------------------
    def rhs(self, u_flat: jnp.ndarray) -> jnp.ndarray:
        """K u + F(u) + b before the mass inverse; u_flat (ne·nd,)."""
        ne, nd = self.ne, self.fes.nd_elem
        u = u_flat.reshape(ne, nd)

        # volume: ∫ u v·∇w
        uq = eval_values(self.db, u)
        y = eval_grad_t(self.db, self.vol_qd * uq[..., None])

        # interior faces: upwind flux
        u0 = jnp.einsum("fqn,fn->fq", self.B0, u[self.e0])
        u1 = jnp.einsum("fqn,fn->fq", self.B1, u[self.e1])
        up = jnp.where(self.vn >= 0.0, u0, u1)
        flux = self.vn * up                                # (nfi, nq_f)
        y0 = -jnp.einsum("fqn,fq->fn", self.B0, flux)
        y1 = jnp.einsum("fqn,fq->fn", self.B1, flux)
        y = y.at[self.e0].add(y0)
        y = y.at[self.e1].add(y1)

        # boundary faces: outflow takes interior value, inflow takes g
        ub = jnp.einsum("fqn,fn->fq", self.bB, u[self.be])
        val = jnp.where(self.bvn >= 0.0, ub, self.g_in)
        bflux = self.bvn * val
        y = y.at[self.be].add(-jnp.einsum("fqn,fq->fn", self.bB, bflux))
        return y.reshape(-1)

    def mult(self, t, u_flat: jnp.ndarray) -> jnp.ndarray:
        ne, nd = self.ne, self.fes.nd_elem
        r = self.rhs(u_flat).reshape(ne, nd)
        return jnp.einsum("emn,en->em", self.Minv, r).reshape(-1)


def project_l2(fes: L2FESpace, f: Callable, dtype=None) -> jnp.ndarray:
    """Nodal projection onto the (Gauss-point nodal) L2 space."""
    from ..fem.fespace import element_node_coords

    mesh = fes.mesh
    # nodal points of the L2 basis are the same lattice as H1 for our build
    X = element_node_coords(mesh, fes.order)
    return jnp.asarray(np.asarray(f(X)).reshape(-1), real_t(dtype))
