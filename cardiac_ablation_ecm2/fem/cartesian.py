"""Structured (Cartesian) FE space with gather-free restriction.

Motivation: the unstructured L↔E gather/scatter moves an index per E-slot
and scatters with multiplicity (SURVEY.md §7 hard part 2).  For Cartesian hex/quad meshes — the target
bioheat workload (BASELINE config 5) — the restriction has *structure*:
with lexicographic dof numbering, the E-vector entry for local lattice
offset (a,b,c) of element (ex,ey,ez) is the global lattice node
(p·ex+a, p·ey+b, p·ez+c).  So

* L→E  = (p+1)^dim **strided slices** of the dof lattice,
* E→L  = (p+1)^dim **strided dense adds** (deterministic, no atomics),

both pure dense/strided ops that XLA executes at copy bandwidth.

``CartesianFESpace`` is duck-type compatible with ``FESpace`` (gather_map,
bdr maps, dof_coords, essential_dofs, d2q) so every operator/solver layer
works unchanged; ``restriction_for`` returns the structured restriction for
it.  Element ordering matches ``make_cartesian_*`` (x fastest).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..mesh.mesh import Mesh
from .basis import DofToQuad, h1_nodes_1d, lattice_multi_index, make_dof_to_quad
from .geometry import Geometry


@dataclasses.dataclass(eq=False)
class StructuredRestriction:
    """Gather-free L↔E restriction on a Cartesian dof lattice."""

    shape_n: Tuple[int, ...]     # elements per axis (nx[, ny[, nz]])
    order: int
    ndof: int

    def __post_init__(self):
        self.dim = len(self.shape_n)
        p = self.order
        self.nshape = tuple(p * n + 1 for n in self.shape_n)  # lattice dims
        self.ne = int(np.prod(self.shape_n))
        self.nd = (p + 1) ** self.dim

    # The decomposition is stride-free (no strided slices): along each axis, the first p of every element's p+1 nodes
    # tile the lattice contiguously (reshape), and the trailing node is the
    # next block's first node (shifted slice) or the final lattice point.

    def _expand(self, u, axis, n):
        """lattice axis of length p·n+1 → (n, p+1) block axes at position
        ``axis`` (replacing it with two axes)."""
        p = self.order
        main = jnp.moveaxis(u, axis, 0)
        head = main[:-1].reshape(n, p, *main.shape[1:])      # (n, p, ...)
        tail = jnp.concatenate(
            [head[1:, :1], main[-1:][None]], axis=0
        )                                                     # (n, 1, ...)
        out = jnp.concatenate([head, tail], axis=1)           # (n, p+1, ...)
        return jnp.moveaxis(out, (0, 1), (axis, axis + 1))

    def _contract(self, e, axis, n):
        """adjoint of _expand: (n, p+1) axes at ``axis`` → lattice axis."""
        p = self.order
        eb = jnp.moveaxis(e, (axis, axis + 1), (0, 1))        # (n, p+1, ...)
        head = eb[:, :p]                                      # (n, p, ...)
        tail = eb[:, p]                                       # (n, ...)
        head = head.at[1:, 0].add(tail[:-1])
        main = head.reshape(n * p, *eb.shape[2:])
        out = jnp.concatenate([main, tail[-1:]], axis=0)      # (p·n+1, ...)
        return jnp.moveaxis(out, 0, axis)

    def mult(self, u: jnp.ndarray) -> jnp.ndarray:
        """(ndof[, c]) → (ne, nd[, c]), stride-free."""
        pr = self.order
        extra = u.shape[1:]
        if self.dim == 3:
            nx, ny, nz = self.shape_n
            v = u.reshape(self.nshape[2], self.nshape[1], self.nshape[0],
                          *extra)
            v = self._expand(v, 0, nz)        # (nz, cz, Ny, Nx, ...)
            v = self._expand(v, 2, ny)        # (nz, cz, ny, cy, Nx, ...)
            v = self._expand(v, 4, nx)        # (nz, cz, ny, cy, nx, cx, ...)
            v = jnp.moveaxis(v, (0, 2, 4, 1, 3, 5), (0, 1, 2, 3, 4, 5))
            # (nz, ny, nx, cz, cy, cx, ...) → (ne, nd) with e x-fastest and
            # local dof cx-fastest (lex)
            return v.reshape(self.ne, self.nd, *extra)
        nx, ny = self.shape_n
        v = u.reshape(self.nshape[1], self.nshape[0], *extra)
        v = self._expand(v, 0, ny)            # (ny, cy, Nx, ...)
        v = self._expand(v, 2, nx)            # (ny, cy, nx, cx, ...)
        v = jnp.moveaxis(v, (0, 2, 1, 3), (0, 1, 2, 3))
        return v.reshape(self.ne, self.nd, *extra)

    def mult_transpose(self, e: jnp.ndarray) -> jnp.ndarray:
        """(ne, nd[, c]) → (ndof[, c]), deterministic stride-free adds."""
        pr = self.order
        extra = e.shape[2:]
        if self.dim == 3:
            nx, ny, nz = self.shape_n
            c1 = pr + 1
            v = e.reshape(nz, ny, nx, c1, c1, c1, *extra)
            v = jnp.moveaxis(v, (0, 1, 2, 3, 4, 5), (0, 2, 4, 1, 3, 5))
            # (nz, cz, ny, cy, nx, cx, ...)
            v = self._contract(v, 4, nx)
            v = self._contract(v, 2, ny)
            v = self._contract(v, 0, nz)
            return v.reshape(self.ndof, *extra)
        nx, ny = self.shape_n
        c1 = pr + 1
        v = e.reshape(ny, nx, c1, c1, *extra)
        v = jnp.moveaxis(v, (0, 1, 2, 3), (0, 2, 1, 3))
        v = self._contract(v, 2, nx)
        v = self._contract(v, 0, ny)
        return v.reshape(self.ndof, *extra)

    def mult_t(self, u: jnp.ndarray) -> jnp.ndarray:
        """L→E transposed (nd, ne) — lane-major layout (ops/lanemajor.py)."""
        return self.mult(u).T

    def mult_transpose_t(self, e_T: jnp.ndarray) -> jnp.ndarray:
        return self.mult_transpose(e_T.T)

    def counts(self) -> jnp.ndarray:
        ones = jnp.ones((self.ne, self.nd))
        return self.mult_transpose(ones).astype(jnp.int32)


@dataclasses.dataclass(eq=False)
class CartesianFESpace:
    """H1 space on a Cartesian quad/hex grid with lexicographic dof
    numbering and structured restriction.  Duck-type compatible with
    ``FESpace``."""

    mesh: Mesh
    order: int
    shape_n: Tuple[int, ...]          # (nx[, ny[, nz]])
    lengths: Tuple[float, ...] = None
    vdim: int = 1

    def __post_init__(self):
        p = self.order
        self.dim = len(self.shape_n)
        if self.lengths is None:
            self.lengths = tuple(
                float(self.mesh.vertices[:, d].max()) for d in range(self.dim)
            )
        self.nshape = tuple(p * n + 1 for n in self.shape_n)
        self.ndof_scalar = int(np.prod(self.nshape))
        self.restriction = StructuredRestriction(
            self.shape_n, p, self.ndof_scalar
        )
        # gather_map by formula (for FULL assembly / cross-checks)
        self.gather_map = self._build_gather().astype(np.int32)
        self.bdr_gather_map = None   # boundary handled via lattice masks

    # ------------------------------------------------------------------
    def _build_gather(self) -> np.ndarray:
        p = self.order
        if self.dim == 3:
            nx, ny, nz = self.shape_n
            Nx, Ny, Nz = self.nshape
            ex, ey, ez = np.meshgrid(
                np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
            )
            ex = ex.ravel(order="F"); ey = ey.ravel(order="F"); ez = ez.ravel(order="F")
            mi = lattice_multi_index(Geometry.CUBE, p)   # (nd, 3)
            gx = p * ex[:, None] + mi[None, :, 0]
            gy = p * ey[:, None] + mi[None, :, 1]
            gz = p * ez[:, None] + mi[None, :, 2]
            return gx + Nx * (gy + Ny * gz)
        nx, ny = self.shape_n
        Nx, Ny = self.nshape
        ex, ey = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        ex = ex.ravel(order="F"); ey = ey.ravel(order="F")
        mi = lattice_multi_index(Geometry.SQUARE, p)
        gx = p * ex[:, None] + mi[None, :, 0]
        gy = p * ey[:, None] + mi[None, :, 1]
        return gx + Nx * gy

    @property
    def ndof(self) -> int:
        return self.ndof_scalar * self.vdim

    @property
    def nd_elem(self) -> int:
        return self.gather_map.shape[1]

    @functools.cached_property
    def d2q(self) -> DofToQuad:
        from ..utils.config import config

        geom = Geometry.CUBE if self.dim == 3 else Geometry.SQUARE
        nq1d = self.order + 1 + config.quad_extra
        return make_dof_to_quad(geom, self.order, nq1d)

    def dof_to_quad(self, nq1d=None) -> DofToQuad:
        geom = Geometry.CUBE if self.dim == 3 else Geometry.SQUARE
        if nq1d is None:
            return self.d2q
        return make_dof_to_quad(geom, self.order, nq1d)

    @functools.cached_property
    def dof_coords(self) -> np.ndarray:
        x1 = [
            np.concatenate(
                [
                    k / self.shape_n[d] * self.lengths[d]
                    + h1_nodes_1d(self.order)[:-1] / self.shape_n[d]
                    * self.lengths[d]
                    for k in range(self.shape_n[d])
                ]
                + [[self.lengths[d]]]
            )
            for d in range(self.dim)
        ]
        grids = np.meshgrid(*x1, indexing="ij")
        return np.stack([g.ravel(order="F") for g in grids], axis=1)

    # ------------------------------------------------------------------
    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        """Boundary-attribute convention of make_cartesian_2d/3d:
        2D: 1=y0, 2=x1, 3=y1, 4=x0; 3D: 1=z0, 2=y0, 3=x1, 4=y1, 5=x0, 6=z1."""
        masks = np.zeros(self.nshape[::-1], dtype=bool)  # (Nz, Ny, Nx) C-order
        if self.dim == 3:
            sel = {1: (0, 0), 6: (0, -1), 2: (1, 0), 4: (1, -1),
                   5: (2, 0), 3: (2, -1)}
        else:
            sel = {1: (0, 0), 3: (0, -1), 4: (1, 0), 2: (1, -1)}
        attrs = (list(bdr_marker) if bdr_marker is not None
                 else list(sel.keys()))
        for a in attrs:
            axis, end = sel[a]      # axis is in C-order: 0=z(slowest)…last=x
            sl = [slice(None)] * self.dim
            sl[axis] = end
            masks[tuple(sl)] = True
        return np.nonzero(masks.reshape(-1))[0].astype(np.int32)
