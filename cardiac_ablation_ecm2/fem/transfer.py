"""Grid transfer operators between FE spaces.

Reference analog: ``TransferOperator`` / ``PRefinementTransferOperator``
(``fem/transfer.hpp:535,566``) and the refinement embedding transfers used by
``Multigrid`` / ``FiniteElementSpaceHierarchy`` (``fem/fespacehierarchy.hpp``).

Design: transfers are element-local interpolations —

* **p-transfer** (same mesh, order pc → pf): the 1D matrix ``I1[qf, ic] =
  L_ic(x_f)`` evaluating coarse GLL basis at fine GLL nodes, applied per axis
  (Kronecker einsum), then averaged into the fine L-vector
  (exact for continuous data).
* **h-transfer** (mesh → uniform refinement, same order): per-octant
  interpolation matrices at child reference nodes; children are ordered
  ``octant·ne + parent`` by ``Mesh.uniform_refinement``.

``restrict_t`` is the exact adjoint of ``prolongate`` (symmetric V-cycles).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..utils.config import real_t
from .basis import h1_nodes, h1_nodes_1d, lagrange_matrices, simplex_basis_matrices
from .build import restriction_for
from .fespace import FESpace
from .geometry import IS_TENSOR, Geometry
from .quadinterp import DeviceBasis, eval_values, eval_values_t


def _interp_db(geom: Geometry, pc: int, pf: int, dtype) -> DeviceBasis:
    """DeviceBasis whose 'quad points' are the order-pf nodes — reuses the
    eval_values einsum machinery as the interpolation kernel."""
    rt = real_t(dtype)
    if IS_TENSOR.get(geom, False):
        I1, _ = lagrange_matrices(h1_nodes_1d(pc), h1_nodes_1d(pf))
        from .geometry import DIMENSION

        return DeviceBasis(
            dim=DIMENSION[geom], tensor=True,
            B1=jnp.asarray(I1, rt), G1=jnp.asarray(np.zeros_like(I1), rt),
            W=None,
        )
    Bf, _ = simplex_basis_matrices(geom, pc, h1_nodes(geom, pf))
    from .geometry import DIMENSION

    return DeviceBasis(
        dim=DIMENSION[geom], tensor=False,
        B=jnp.asarray(Bf, rt), G=None, W=None,
    )


@dataclasses.dataclass(eq=False)
class PTransfer:
    """Order transfer on a fixed mesh (PRefinementTransferOperator analog)."""

    coarse: FESpace
    fine: FESpace
    dtype: object = None

    def __post_init__(self):
        assert self.coarse.mesh is self.fine.mesh
        self.db = _interp_db(
            self.coarse.mesh.geom, self.coarse.order, self.fine.order,
            self.dtype,
        )
        self.Rc = restriction_for(self.coarse)
        self.Rf = restriction_for(self.fine)
        ones = jnp.ones(self.fine.ndof_scalar, dtype=real_t(self.dtype))
        self.mult_f = self.Rf.mult_transpose(self.Rf.mult(ones))
        self.inv_mult_f = 1.0 / self.mult_f

    def prolongate(self, uc: jnp.ndarray) -> jnp.ndarray:
        e = eval_values(self.db, self.Rc.mult(uc))
        return self.inv_mult_f * self.Rf.mult_transpose(e)

    def restrict_t(self, rf: jnp.ndarray) -> jnp.ndarray:
        """Exact adjoint of prolongate."""
        e = self.Rf.mult(self.inv_mult_f * rf)
        return self.Rc.mult_transpose(eval_values_t(self.db, e))


@dataclasses.dataclass(eq=False)
class HTransfer:
    """Uniform-refinement transfer (same order, parent → 2^dim children)."""

    coarse: FESpace
    fine: FESpace
    dtype: object = None

    def __post_init__(self):
        geom = self.coarse.mesh.geom
        p = self.coarse.order
        assert self.fine.order == p
        dim = self.coarse.mesh.dim
        nchild = 2**dim if geom != Geometry.TRIANGLE else 4
        ne_c = self.coarse.mesh.ne
        assert self.fine.mesh.ne == nchild * ne_c
        rt = real_t(self.dtype)

        ref = h1_nodes(geom, p)                       # (nd, dim)
        mats = []
        if geom == Geometry.TRIANGLE:
            # children: [v0,m01,m20], [m01,v1,m12], [m20,m12,v2], [m01,m12,m20]
            corners = [
                ((0, 0), (0.5, 0), (0, 0.5)),
                ((0.5, 0), (1, 0), (0.5, 0.5)),
                ((0, 0.5), (0.5, 0.5), (0, 1)),
                ((0.5, 0), (0.5, 0.5), (0, 0.5)),
            ]
            for cs in corners:
                v0 = np.array(cs[0])
                e1 = np.array(cs[1]) - v0
                e2 = np.array(cs[2]) - v0
                pts = v0 + ref[:, :1] * e1 + ref[:, 1:] * e2
                B, _ = simplex_basis_matrices(geom, p, pts)
                mats.append(B)
        else:
            from .geometry import REF_VERTS

            offsets = REF_VERTS[geom].astype(np.float64)  # {0,1}^dim corners
            for off in offsets:
                if IS_TENSOR.get(geom, False):
                    B = _tensor_child_interp(geom, p, off)
                else:
                    pts = (off[None, :] + ref) / 2.0
                    B, _ = simplex_basis_matrices(geom, p, pts)
                mats.append(B)
        self.I = jnp.asarray(np.stack(mats), rt)      # (nchild, nd, nd)
        self.nchild, self.ne_c = nchild, ne_c
        self.Rc = restriction_for(self.coarse)
        self.Rf = restriction_for(self.fine)
        ones = jnp.ones(self.fine.ndof_scalar, rt)
        self.inv_mult_f = 1.0 / self.Rf.mult_transpose(self.Rf.mult(ones))

    def prolongate(self, uc: jnp.ndarray) -> jnp.ndarray:
        e_c = self.Rc.mult(uc)                        # (ne_c, nd)
        # fine E ordered child-major: octant o, parent e → index o*ne_c + e
        e_f = jnp.einsum("omn,en->oem", self.I, e_c).reshape(
            self.nchild * self.ne_c, -1
        )
        return self.inv_mult_f * self.Rf.mult_transpose(e_f)

    def restrict_t(self, rf: jnp.ndarray) -> jnp.ndarray:
        e_f = self.Rf.mult(self.inv_mult_f * rf).reshape(
            self.nchild, self.ne_c, -1
        )
        e_c = jnp.einsum("omn,oem->en", self.I, e_f)
        return self.Rc.mult_transpose(e_c)


def _tensor_child_interp(geom: Geometry, p: int, off: np.ndarray) -> np.ndarray:
    """Dense (nd, nd) child-node interpolation for tensor geometries in
    lexicographic ordering (row = fine node, col = coarse basis)."""
    from .geometry import DIMENSION

    dim = DIMENSION[geom]
    x1 = h1_nodes_1d(p)
    axes = []
    for d in range(dim):
        xt = (off[d] + x1) / 2.0
        I1, _ = lagrange_matrices(x1, xt)
        axes.append(I1)
    n1 = p + 1
    if dim == 1:
        return axes[0]
    if dim == 2:
        M = np.einsum("ai,bj->abij", axes[1], axes[0])
        return M.reshape(n1 * n1, n1 * n1)
    M = np.einsum("ai,bj,ck->abcijk", axes[2], axes[1], axes[0])
    return M.reshape(n1**3, n1**3)
