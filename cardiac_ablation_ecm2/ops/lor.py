"""Low-order-refined (LOR) preconditioning.

Reference analog: ``LORDiscretization`` / LOR-AMG (``fem/lor/lor.hpp:69``) —
the order-p operator is spectrally equivalent to the order-1 operator on the
refined mesh whose vertices are the high-order nodal points, so a cheap
solver for the LOR matrix preconditions the matrix-free high-order CG.

Twist: the LOR mesh needs no new dof numbering — its vertices ARE
the high-order dofs (the GLL lattice), so sub-element connectivity comes
straight from ``gather_map`` lattice slices and the assembled CSR acts on
high-order L-vectors directly.  The factorized solve runs host-side (scipy),
the role hypre BoomerAMG plays in the reference; the all-device alternative
remains p/h-multigrid (``linalg/multigrid.py``).
"""

from __future__ import annotations

import numpy as np

from ..fem.basis import lattice_multi_index, make_dof_to_quad
from ..fem.geometry import DIMENSION, Geometry
from ..fem.geom_factors import adjugate, compute_geometric_factors
from ..fem.fespace import element_node_coords


def lor_corner_slots(geom, p: int) -> np.ndarray:
    """(p^dim, 2^dim) per-element lattice slots of every LOR sub-element.

    Corner order is the LEX lattice order of ``make_dof_to_quad(geom, 1)``
    (i fastest), matching the Q1 element matrices — not the MFEM cyclic
    vertex order."""
    dim = DIMENSION[geom]
    assert geom in (Geometry.SQUARE, Geometry.CUBE), "LOR: tensor meshes"
    mi = lattice_multi_index(geom, p)
    lookup = {tuple(r): i for i, r in enumerate(mi)}
    corners = []
    rng = range(p)
    if dim == 2:
        # local sub-quad corner slots, lex lattice order
        for j in rng:
            for i in rng:
                corners.append([
                    lookup[(i, j)], lookup[(i + 1, j)],
                    lookup[(i, j + 1)], lookup[(i + 1, j + 1)],
                ])
    else:
        for k in rng:
            for j in rng:
                for i in rng:
                    corners.append([
                        lookup[(i, j, k)], lookup[(i + 1, j, k)],
                        lookup[(i, j + 1, k)], lookup[(i + 1, j + 1, k)],
                        lookup[(i, j, k + 1)], lookup[(i + 1, j, k + 1)],
                        lookup[(i, j + 1, k + 1)],
                        lookup[(i + 1, j + 1, k + 1)],
                    ])
    return np.array(corners, dtype=np.int64)              # (p^dim, 2^dim)


def lor_submesh_connectivity(fes) -> np.ndarray:
    """(ne·p^dim, 2^dim) sub-element connectivity in HIGH-ORDER dof ids."""
    corners = lor_corner_slots(fes.mesh.geom, fes.order)
    gm = fes.gather_map.astype(np.int64)                  # (ne, nd)
    return gm[:, corners].reshape(-1, corners.shape[1])


def lor_matrix(fes, diffusion_coeff=1.0, mass_coeff=None):
    """Assembled LOR CSR acting on high-order L-vectors (scipy)."""
    import scipy.sparse as sps

    mesh, p = fes.mesh, fes.order
    geom = mesh.geom
    conn = lor_submesh_connectivity(fes)                  # (nsub, nv)
    X = element_node_coords(mesh, p)                      # (ne, nd, sdim)
    dim = DIMENSION[geom]
    nsub_per = p ** dim
    ne = mesh.ne
    d2q1 = make_dof_to_quad(geom, 1, 2)
    # sub-element corner slots in the per-element lattice (same order as conn)
    corners = lor_corner_slots(geom, p)
    Xc = X[:, corners, :].reshape(ne * nsub_per, corners.shape[1], -1)
    gf = compute_geometric_factors(Xc, d2q1, dtype="float64")
    B = d2q1.full_B()
    G = d2q1.full_G()
    A_e = None
    if diffusion_coeff is not None:
        qd = np.asarray(adjugate(np.asarray(gf.jac)))
        det = np.asarray(gf.det)
        w = np.asarray(d2q1.weights)
        # D = w/det · adj adjᵀ · coeff
        D = (diffusion_coeff * w[None, :, None, None] / det[..., None, None]
             * np.einsum("eqab,eqcb->eqac", qd, qd))
        A_e = np.einsum("qma,eqab,qnb->emn", G, D, G)
    if mass_coeff is not None:
        w = np.asarray(d2q1.weights)
        q = mass_coeff * w[None, :] * np.asarray(gf.det)
        t = np.einsum("qm,eq,qn->emn", B, q, B)
        A_e = t if A_e is None else A_e + t
    nv = conn.shape[1]
    rows = np.repeat(conn, nv, axis=1).reshape(-1)
    cols = np.tile(conn, (1, nv)).reshape(-1)
    return sps.coo_matrix(
        (A_e.reshape(-1), (rows, cols)),
        shape=(fes.ndof_scalar, fes.ndof_scalar),
    ).tocsr()


class LORPreconditioner:
    """Factorized LOR solve as a CG preconditioner (host-side splu — the
    BoomerAMG seat; spectrally equivalent to the high-order operator)."""

    def __init__(self, fes, diffusion_coeff=1.0, mass_coeff=None, ess=None):
        import scipy.sparse as sps
        import scipy.sparse.linalg as spla

        A = lor_matrix(fes, diffusion_coeff, mass_coeff).tocsr()
        n = A.shape[0]
        if ess is not None and len(ess):
            mask = np.zeros(n, dtype=bool)
            mask[ess] = True
            keep = ~mask
            # pin essential rows/cols: identity there
            A = A.tolil()
            A[np.nonzero(mask)[0], :] = 0.0
            A[:, np.nonzero(mask)[0]] = 0.0
            for i in np.nonzero(mask)[0]:
                A[i, i] = 1.0
            A = A.tocsc()
        else:
            A = A.tocsc()
        self._lu = spla.splu(A)

    def __call__(self, r):
        import jax

        def solve(rr):
            return self._lu.solve(
                np.asarray(rr, dtype=np.float64)
            ).astype(np.asarray(rr).dtype)

        # pure_callback: usable inside jitted/while_loop CG bodies
        return jax.pure_callback(
            solve, jax.ShapeDtypeStruct(r.shape, r.dtype), r
        )
