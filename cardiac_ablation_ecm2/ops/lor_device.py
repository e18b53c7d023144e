"""All-device LOR preconditioning: batched LOR assembly + geometric MG.

Reference analog: batched LOR assembly (``fem/lor/lor_batched.hpp:34``,
``AssemblyKernel``) wrapped in ``LORSolver<HypreBoomerAMG>``
(``fem/lor/lor.hpp:201``).  The host-factorized seat lives in ``ops/lor.py``
(scipy splu behind ``pure_callback``); THIS module is the production path —
everything stays on device and works under ``shard_map``:

* the LOR element matrices of all ``ne * p^dim`` Q1 sub-elements are
  assembled in ONE batched einsum chain (geometric factors of the
  sub-hexes come straight from lattice slices of the high-order node
  coordinates — the LOR vertices ARE the order-p GLL nodes, so no new
  dof numbering exists, exactly the ``lor_submesh_connectivity`` trick);
* the LOR operator applies as gather → ``(nsub,nv,nv)@(nsub,nv)`` batched
  matvec → scatter-add, all XLA;
* the BoomerAMG seat is a geometric V-cycle: Chebyshev smoothing on the
  LOR lattice over an order-1 coarse space on the original mesh
  (``fem/transfer.PTransfer``), recursing into the existing h/p hierarchy
  if one is supplied.

The sharded counterpart (same matrices, halo-summed scatter) is
``parallel/poisson.py`` (precond="lor").
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fem.basis import make_dof_to_quad
from ..fem.fespace import FESpace, element_node_coords
from ..fem.geometry import DIMENSION, Geometry
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..fem.restriction import ElementRestriction
from ..utils.config import real_t
from .lor import lor_corner_slots


def lor_element_matrices(fes, diffusion_coeff=1.0, mass_coeff=None,
                         dtype=None):
    """Batched on-device LOR element matrices.

    Returns ``(A_e, conn)``: ``A_e`` is a ``(nsub, nv, nv)`` jnp array of
    Q1 diffusion(+mass) matrices for every LOR sub-element, ``conn`` the
    ``(nsub, nv)`` connectivity in HIGH-ORDER dof ids (numpy, host side).

    Coefficients may be scalars or callables of physical coordinates
    (evaluated at the sub-element quadrature points).  Mirrors the host
    ``lor_matrix`` math (same Q1 quadrature) so the two agree to roundoff.
    """
    mesh, p = fes.mesh, fes.order
    geom = mesh.geom
    assert geom in (Geometry.SQUARE, Geometry.CUBE), "LOR: tensor meshes"
    rt = real_t(dtype)
    dim = DIMENSION[geom]
    corners = lor_corner_slots(geom, p)                   # (nsub_per, nv)
    X = jnp.asarray(element_node_coords(mesh, p), rt)     # (ne, nd, sdim)
    nv = corners.shape[1]
    Xc = X[:, corners, :].reshape(-1, nv, X.shape[-1])    # (nsub, nv, sdim)
    d2q1 = make_dof_to_quad(geom, 1, 2)
    gf = compute_geometric_factors(Xc, d2q1, rt)
    B = jnp.asarray(d2q1.full_B(), rt)                    # (nq, nv)
    G = jnp.asarray(d2q1.full_G(), rt)                    # (nq, nv, sdim)
    w = jnp.asarray(d2q1.weights, rt)

    def _coef(c):
        if c is None:
            return None
        if callable(c):
            return jnp.asarray(c(gf.x), rt)               # (nsub, nq)
        return jnp.asarray(c, rt)

    kd = _coef(diffusion_coeff)
    km = _coef(mass_coeff)
    A_e = None
    if kd is not None:
        adj = adjugate(gf.jac)                            # (nsub, nq, d, d)
        D = (w[None, :, None, None] / gf.det[..., None, None]
             * jnp.einsum("eqab,eqcb->eqac", adj, adj))
        if kd.ndim:
            D = D * kd[..., None, None]
        else:
            D = D * kd
        A_e = jnp.einsum("qma,eqab,qnb->emn", G, D, G)
    if km is not None:
        q = w[None, :] * gf.det * km
        A_e = (0.0 if A_e is None else A_e) + jnp.einsum(
            "qm,eq,qn->emn", B, q, B)
    gm = fes.gather_map.astype(np.int64)                  # (ne, nd)
    conn = gm[:, corners].reshape(-1, nv)
    return A_e, conn


class DeviceLOROperator:
    """Matrix-free LOR operator on high-order L-vectors (all device).

    ``mult`` is the constrained apply (identity on essential dofs) when
    ``ess`` is given, matching the convention of the high-order constrained
    operators it preconditions.
    """

    def __init__(self, fes, diffusion_coeff=1.0, mass_coeff=None, ess=None,
                 dtype=None):
        rt = real_t(dtype)
        A_e, conn = lor_element_matrices(
            fes, diffusion_coeff, mass_coeff, dtype)
        self.A_e = A_e
        self.restr = ElementRestriction.from_map(conn, fes.ndof_scalar)
        self.ndof = fes.ndof_scalar
        mask = jnp.zeros(self.ndof, rt)
        if ess is not None and len(ess):
            mask = mask.at[jnp.asarray(ess)].set(1.0)
        self.ess_mask = mask

    def mult(self, x):
        m = self.ess_mask
        z = x * (1.0 - m)
        e = self.restr.mult(z)                            # (nsub, nv)
        y = self.restr.mult_transpose(
            jnp.einsum("snm,sm->sn", self.A_e, e))
        return y * (1.0 - m) + x * m

    def diagonal(self):
        d = self.restr.mult_transpose(
            jnp.diagonal(self.A_e, axis1=1, axis2=2))
        m = self.ess_mask
        d = d * (1.0 - m) + m
        return jnp.where(d == 0.0, 1.0, d)


def make_lor_multigrid(fes, diffusion_coeff=1.0, mass_coeff=None,
                       ess_bdr=None, smoother_order=3, coarse_iters=32,
                       dtype=None):
    """Geometric MG on the LOR lattice — the all-device BoomerAMG seat.

    Two levels: fine = the Chebyshev-smoothed LOR operator acting on the
    order-p dofs, coarse = the order-1 PA operator on the original mesh,
    connected by the order transfer (the order-1 space is exactly the LOR
    lattice coarsened back to the element corners).  Returns a
    ``linalg.multigrid.Multigrid``; ``.preconditioner()`` drops into any CG.
    """
    from ..fem.transfer import PTransfer
    from ..linalg.multigrid import MGLevel, Multigrid
    from ..linalg.smoothers import chebyshev
    from .bilinearform import BilinearForm

    ess_f = fes.essential_dofs(ess_bdr)
    lor_op = DeviceLOROperator(fes, diffusion_coeff, mass_coeff,
                               ess=ess_f, dtype=dtype)

    fes1 = FESpace(fes.mesh, 1)
    bf = BilinearForm(fes1)
    if diffusion_coeff is not None:
        bf.add_domain_integrator("diffusion", coeff=diffusion_coeff)
    if mass_coeff is not None:
        bf.add_domain_integrator("mass", coeff=mass_coeff)
    A1 = bf.assemble(dtype=dtype)
    ess_c = fes1.essential_dofs(ess_bdr)
    rt = real_t(dtype)
    m1 = jnp.zeros(fes1.ndof_scalar, rt)
    if len(ess_c):
        m1 = m1.at[jnp.asarray(ess_c)].set(1.0)

    def A1c(x, m=m1):
        z = x * (1.0 - m)
        return A1.mult(z) * (1.0 - m) + x * m

    d1 = A1.diagonal() * (1.0 - m1) + m1
    d1 = jnp.where(d1 == 0.0, 1.0, d1)

    tr = PTransfer(fes1, fes, dtype=dtype)
    levels = [
        MGLevel(A1c, chebyshev(A1c, d1, order=smoother_order),
                None, None, jnp.asarray(ess_c) if len(ess_c) else None),
        MGLevel(lor_op.mult,
                chebyshev(lor_op.mult, lor_op.diagonal(),
                          order=smoother_order),
                tr.prolongate, tr.restrict_t,
                jnp.asarray(ess_f) if len(ess_f) else None),
    ]
    return Multigrid(levels=levels, coarse_iters=coarse_iters)
