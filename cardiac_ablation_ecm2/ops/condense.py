"""Static condensation for H1 partial-assembly operators.

Reference analog: ``StaticCondensation`` (``fem/staticcond.hpp:63``) used via
``BilinearForm::EnableStaticCondensation`` — eliminate element-interior dofs
so the Krylov solve runs on the (much smaller) interface space, then recover
interiors elementwise.

Design: per-element dense blocks (the same data MFEM assembles) batched
on the leading element axis:

    S_e   = A_ff − A_fc A_cc⁻¹ A_cf          (ne, nf, nf)
    y_f   = Σ_e Rᵀ_f S_e R_f x_f              — one gather/einsum/scatter
    x_c   = A_cc⁻¹ (b_c − A_cf x_f)           — batched recovery

Interior dofs of a tensor H1 element (the CELL-entity lattice nodes) belong
to exactly one element, so the interface space is simply the global dof set
minus interiors.  Essential BCs live on the interface (boundary nodes are
never interior) and are applied on the condensed system.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..fem.basis import lattice_multi_index
from ..fem.build import geom_factors_for
from ..utils.config import index_t, real_t
from . import diffusion as dmod
from . import mass as mmod


def element_matrices(fes, diffusion_coeff=None, mass_coeff=None,
                     nq1d=None, dtype=None) -> np.ndarray:
    """Batched dense element matrices (ne, nd, nd) from PA qdata."""
    gf = geom_factors_for(fes, nq1d, dtype)
    d2q = fes.d2q if nq1d is None else fes.dof_to_quad(nq1d)
    A = None
    if diffusion_coeff is not None:
        G = d2q.full_G()                             # (nq, nd, dim)
        qd = np.asarray(dmod.setup(gf, diffusion_coeff))   # (ne, nq, d, d)
        t = np.einsum("qma,eqab,qnb->emn", G, qd, G)
        A = t
    if mass_coeff is not None:
        B = d2q.full_B()
        qd = np.asarray(mmod.setup(gf))
        if not np.isscalar(mass_coeff):
            raise NotImplementedError("scalar mass coeff only")
        t = mass_coeff * np.einsum("qm,eq,qn->emn", B, qd, B)
        A = t if A is None else A + t
    return A


@dataclasses.dataclass(eq=False)
class StaticCondensation:
    """Condensed interface operator + RHS reduction + interior recovery."""

    fes: object
    A_e: np.ndarray               # (ne, nd, nd) element matrices

    def __post_init__(self):
        fes = self.fes
        p = fes.order
        mi = lattice_multi_index(fes.mesh.geom, p)
        interior = np.all((mi > 0) & (mi < p), axis=1)   # CELL lattice nodes
        self.loc_f = np.nonzero(~interior)[0]
        self.loc_c = np.nonzero(interior)[0]
        gm = fes.gather_map.astype(np.int64)             # (ne, nd)

        # interface global numbering: dofs touched by any interface slot
        iface_dofs = np.unique(gm[:, self.loc_f].reshape(-1))
        self.n_iface = len(iface_dofs)
        g2c = np.full(fes.ndof_scalar, -1, dtype=np.int64)
        g2c[iface_dofs] = np.arange(self.n_iface)
        self.iface_dofs = iface_dofs                     # condensed → global
        self.gather_f = jnp.asarray(g2c[gm[:, self.loc_f]], index_t())
        self.gather_c = jnp.asarray(gm[:, self.loc_c], index_t())

        A = np.asarray(self.A_e)
        Aff = A[:, self.loc_f][:, :, self.loc_f]
        Afc = A[:, self.loc_f][:, :, self.loc_c]
        Acf = A[:, self.loc_c][:, :, self.loc_f]
        Acc = A[:, self.loc_c][:, :, self.loc_c]
        Acc_inv = np.linalg.inv(Acc)
        S = Aff - np.einsum("emk,ekl,eln->emn", Afc, Acc_inv, Acf)
        rt = real_t(None)
        self.S = jnp.asarray(S, rt)
        self.Acc_inv = jnp.asarray(Acc_inv, rt)
        self.Afc = jnp.asarray(Afc, rt)
        self.Acf = jnp.asarray(Acf, rt)

    # -- condensed operator -------------------------------------------------
    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        e = x[self.gather_f]                             # (ne, nf)
        y = jnp.einsum("emn,en->em", self.S, e)
        out = jnp.zeros(self.n_iface, dtype=x.dtype)
        return out.at[self.gather_f.reshape(-1)].add(y.reshape(-1))

    def diagonal(self) -> jnp.ndarray:
        d = jnp.einsum("enn->en", self.S)
        out = jnp.zeros(self.n_iface, dtype=d.dtype)
        return out.at[self.gather_f.reshape(-1)].add(d.reshape(-1))

    # -- RHS reduction and recovery ------------------------------------------
    def reduce_rhs(self, b: jnp.ndarray) -> jnp.ndarray:
        """Full L-vector RHS → condensed RHS b_f − A_fc A_cc⁻¹ b_c."""
        bc = b[self.gather_c]                            # (ne, nc)
        t = jnp.einsum("emk,ekl,el->em", self.Afc, self.Acc_inv, bc)
        out = jnp.zeros(self.n_iface, dtype=b.dtype)
        out = out.at[self.gather_f.reshape(-1)].add(-t.reshape(-1))
        # b_f: interface entries of the global RHS, in condensed ordering
        # (condensed id i ↔ global dof iface_dofs[i])
        return out + b[jnp.asarray(self.iface_dofs, index_t())]

    def recover(self, x_f: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Condensed solution → full L-vector (interiors back-substituted)."""
        full = jnp.zeros(self.fes.ndof_scalar, dtype=x_f.dtype)
        full = full.at[jnp.asarray(self.iface_dofs, index_t())].set(x_f)
        ef = x_f[self.gather_f]
        bc = b[self.gather_c]
        xc = jnp.einsum(
            "ekl,el->ek", self.Acc_inv,
            bc - jnp.einsum("ekm,em->ek", self.Acf, ef),
        )
        return full.at[self.gather_c.reshape(-1)].set(xc.reshape(-1))

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Essential dofs in condensed numbering."""
        ess = self.fes.essential_dofs(bdr_marker)
        g2c = np.full(self.fes.ndof_scalar, -1, dtype=np.int64)
        g2c[self.iface_dofs] = np.arange(self.n_iface)
        c = g2c[ess]
        assert (c >= 0).all(), "essential dof eliminated as interior?"
        return c.astype(np.int32)
