"""Serendipity H1 elements on quads (orders 2–3).

Reference analog: ``H1Ser_FECollection`` / ``H1Ser_QuadrilateralElement``
(``fem/fe_coll.hpp:347``, ``fem/fe/fe_ser.cpp``) — the reduced-dof H1
family with no interior dofs below order 4:

    S_p = P_p ⊕ span{x^p y, x y^p},    dim = 4 + 4(p−1)  (p ≤ 3)

Design: nodal basis (4 corners + p−1 GLL points per edge) built by
Vandermonde inversion over the serendipity monomials; the space is an
entity-dof enumeration (vertices + direction-canonicalized edge dofs) and
the operators are dense batched einsums — the same pattern as the
variable-order spaces (the element is small, 8 or 12 dofs)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..mesh.mesh import Mesh, unique_edges
from ..utils.config import index_t
from .basis import h1_nodes_1d
from .geometry import EDGES, Geometry


def _monomials(p: int):
    """Exponent pairs of S_p."""
    out = [(i, j) for i in range(p + 1) for j in range(p + 1 - i)]
    out += [(p, 1), (1, p)]
    return out


def serendipity_nodes(p: int) -> np.ndarray:
    """(nd, 2) nodal points: corners then edge GLL interiors (edge order
    of EDGES[SQUARE], params ascending along each edge)."""
    assert p in (2, 3), "serendipity: orders 2-3 (order 4+ needs interior)"
    corners = np.array([(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)])
    gll = h1_nodes_1d(p)[1:p]
    pts = [corners]
    for (a, b) in EDGES[Geometry.SQUARE]:
        va, vb = corners[a], corners[b]
        pts.append(va[None] + gll[:, None] * (vb - va)[None])
    return np.concatenate(pts, axis=0)


def serendipity_basis_matrices(p: int, pts: np.ndarray):
    """(B (npts, nd), G (npts, nd, 2)) of the nodal serendipity basis."""
    nodes = serendipity_nodes(p)
    monos = _monomials(p)
    V = np.array([[x ** i * y ** j for (i, j) in monos]
                  for (x, y) in nodes])
    C = np.linalg.inv(V)                           # monomial coeffs per fn
    x, y = pts[:, 0], pts[:, 1]
    M = np.stack([x ** i * y ** j for (i, j) in monos], axis=1)
    Mx = np.stack([(i * x ** max(i - 1, 0) * y ** j if i else 0 * x)
                   for (i, j) in monos], axis=1)
    My = np.stack([(j * x ** i * y ** max(j - 1, 0) if j else 0 * x)
                   for (i, j) in monos], axis=1)
    B = M @ C
    G = np.stack([Mx @ C, My @ C], axis=-1)
    return B, G


@dataclasses.dataclass(eq=False)
class SerendipityFESpace:
    """Conforming S_p space on a quad mesh (vertices + edge dofs only)."""

    mesh: Mesh
    order: int

    def __post_init__(self):
        mesh, p = self.mesh, self.order
        assert mesh.geom == Geometry.SQUARE
        assert p in (2, 3)
        edges, elem_edge = unique_edges(mesh)
        nv, nedge = mesh.nv, len(edges)
        self._edges = edges
        self.ndof = nv + nedge * (p - 1)
        nd = 4 + 4 * (p - 1)
        gm = np.zeros((mesh.ne, nd), dtype=np.int64)
        gm[:, :4] = mesh.elements
        for le, (a, b) in enumerate(EDGES[Geometry.SQUARE]):
            eid = elem_edge[:, le]                       # (ne,)
            ga, gb = mesh.elements[:, a], mesh.elements[:, b]
            fwd = ga < gb                                # min→max direction
            base = nv + eid * (p - 1)
            for k in range(p - 1):
                # local node k sits at ascending local param; global dof k
                # counts along the min→max direction
                kk = np.where(fwd, k, p - 2 - k)
                gm[:, 4 + le * (p - 1) + k] = base + kk
        self.gather_map = gm
        self.ndof_scalar = self.ndof

    @property
    def nd_elem(self):
        return self.gather_map.shape[1]

    def dof_coords(self) -> np.ndarray:
        ref = serendipity_nodes(self.order)
        V = self.mesh.vertices[self.mesh.elements]       # (ne, 4, 2)
        u, v = ref[:, 0], ref[:, 1]
        phys = ((1 - u)[:, None] * (1 - v)[:, None] * V[:, None, 0]
                + u[:, None] * (1 - v)[:, None] * V[:, None, 1]
                + u[:, None] * v[:, None] * V[:, None, 2]
                + (1 - u)[:, None] * v[:, None] * V[:, None, 3])
        X = np.zeros((self.ndof, 2))
        X[self.gather_map.reshape(-1)] = phys.reshape(-1, 2)
        return X

    def essential_dofs(self, bdr_marker=None) -> np.ndarray:
        mesh = self.mesh
        p = self.order
        ekey = {tuple(sorted(map(int, r))): i
                for i, r in enumerate(self._edges)}
        out = set()
        for row, a in zip(mesh.boundary, mesh.bdr_attributes):
            if bdr_marker is not None and int(a) not in set(bdr_marker):
                continue
            va, vb = int(row[0]), int(row[1])
            out.update((va, vb))
            eid = ekey[tuple(sorted((va, vb)))]
            for k in range(p - 1):
                out.add(mesh.nv + eid * (p - 1) + k)
        return np.array(sorted(out), dtype=np.int64)


def serendipity_operator(sp: SerendipityFESpace, diffusion_coeff=1.0,
                         mass_coeff=None, nq1d=None, dtype=None):
    """Matrix-free (κ∇u,∇v) [+ (m u,v)] — (mult, diagonal) closures."""
    import jax.numpy as jnp

    from ..utils.config import real_t
    from .basis import make_dof_to_quad
    from .fespace import element_node_coords
    from .geom_factors import adjugate, compute_geometric_factors

    rt = real_t(dtype)
    mesh = sp.mesh
    p = sp.order
    if nq1d is None:
        nq1d = p + 2
    d2q = make_dof_to_quad(Geometry.SQUARE, 1, nq1d)
    gf = compute_geometric_factors(
        jnp.asarray(element_node_coords(mesh, 1), rt), d2q, dtype)
    pts = np.asarray(d2q.points)
    B, G = serendipity_basis_matrices(p, pts)
    B = jnp.asarray(B, rt)
    A = adjugate(gf.jac)
    Gphys = jnp.einsum("eqab,qna->eqnb",
                       A / gf.det[..., None, None], jnp.asarray(G, rt))
    qd_k = (diffusion_coeff * gf.wdet)
    qd_m = None if mass_coeff is None else mass_coeff * gf.wdet
    gm = jnp.asarray(sp.gather_map, index_t())
    ndof = sp.ndof

    def mult(x):
        e = x[gm]                                     # (ne, nd)
        g = jnp.einsum("eqnc,en->eqc", Gphys, e)
        y = jnp.einsum("eqnc,eqc->en", Gphys, qd_k[..., None] * g)
        if qd_m is not None:
            u = jnp.einsum("qn,en->eq", B, e)
            y = y + jnp.einsum("qn,eq->en", B, qd_m * u)
        out = jnp.zeros(ndof, x.dtype)
        return out.at[gm.reshape(-1)].add(y.reshape(-1))

    def diagonal():
        d = jnp.einsum("eqnc,eq,eqnc->en", Gphys, qd_k, Gphys)
        if qd_m is not None:
            d = d + jnp.einsum("qn,eq,qn->en", B, qd_m, B)
        out = jnp.zeros(ndof)
        return out.at[gm.reshape(-1)].add(d.reshape(-1))

    return mult, diagonal
