"""Anisotropic NC quad refinement (NCMesh ref_type analog,
mesh/ncmesh.hpp:33,176): typed splits, typed 2:1 balance, and conforming
exactness through anisotropic hanging nodes."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import (
    basis_for,
    geom_factors_for,
    restriction_for,
)
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.ncmesh import (
    ISO,
    X,
    Y,
    make_nc,
    refine_quads_aniso,
)
from cardiac_ablation_ecm2.ops import BilinearForm


def test_x_split_geometry():
    """X-split of one quad of a 2×1 strip: 3 elements, 2 hanging-free."""
    nc = make_nc(make_cartesian_2d(2, 1))
    types = np.array([X, 0])
    nc2, parent = refine_quads_aniso(nc, types)
    assert nc2.mesh.ne == 3
    assert nc2.n_hanging == 0            # conforming: split edge on boundary
    assert sorted(parent.tolist()) == [0, 0, 1]


def test_y_split_creates_hanging():
    """Y-split of one quad of a 2×1 strip hangs a vertex on the shared
    x-normal edge? No — the shared edge is vertical; Y splits it."""
    nc = make_nc(make_cartesian_2d(2, 1))
    nc2, _ = refine_quads_aniso(nc, np.array([Y, 0]))
    assert nc2.mesh.ne == 3
    assert nc2.n_hanging == 1            # midpoint of the shared edge hangs
    v, a, b = nc2.constraints[0]
    mid = 0.5 * (nc2.mesh.vertices[a] + nc2.mesh.vertices[b])
    assert np.array_equal(mid, nc2.mesh.vertices[v])


def test_typed_balance_propagation():
    """Double Y-split next to an unrefined quad forces a Y-split (not an
    iso split) of the neighbor."""
    nc = make_nc(make_cartesian_2d(2, 1))
    nc1, _ = refine_quads_aniso(nc, np.array([Y, 0]))
    # refine the two children of element 0 again in y
    types = np.zeros(nc1.mesh.ne, dtype=np.int64)
    for e in range(nc1.mesh.ne):
        cent = nc1.mesh.vertices[nc1.mesh.elements[e]].mean(axis=0)
        if cent[0] < 0.5:
            types[e] = Y
    nc2, _ = refine_quads_aniso(nc1, types)
    # neighbor was forced: total elements = 4 (left) + 2 (right, y-split)
    assert nc2.mesh.ne == 6, nc2.mesh.ne
    # and the mesh is 2:1-balanced (refine with no marks is a no-op)
    nc3, _ = refine_quads_aniso(nc2, np.zeros(nc2.mesh.ne, dtype=np.int64))
    assert nc3.mesh.ne == nc2.mesh.ne


@pytest.mark.parametrize("p", [1, 2, 3])
def test_conforming_projection_exact_aniso(p):
    """Degree-p polynomial is reproduced exactly through anisotropic
    hanging nodes after prolongation."""
    nc = make_nc(make_cartesian_2d(3, 3))
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    types = np.where(cent[:, 0] < 1 / 3, X, 0)
    types = np.where(cent[:, 1] > 2 / 3, Y, types)
    types[0] = ISO
    nc, _ = refine_quads_aniso(nc, types)
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    types2 = np.where((cent[:, 0] < 1 / 6) & (cent[:, 1] < 1 / 3), Y, 0)
    nc, _ = refine_quads_aniso(nc, types2)
    sp = NCFESpace(nc, p)
    assert sp.n_slaves > 0

    def f(x):
        x = np.asarray(x)
        out = x[..., 0] ** p + 0.3 * x[..., 1]
        if p >= 2:
            out = out + x[..., 0] * x[..., 1] ** (p - 1)
        return out

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_ptap_matches_scipy_aniso(p=2):
    """Matrix-free PᵀAP == scipy PᵀAP on an anisotropically refined mesh."""
    import scipy.sparse as sp_

    nc = make_nc(make_cartesian_2d(3, 3))
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    nc, _ = refine_quads_aniso(
        nc, np.where(cent[:, 0] < 1 / 3, X,
                     np.where(cent[:, 1] > 2 / 3, Y, 0)))
    sp = NCFESpace(nc, p)
    fes = sp.fes
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A_L = a.assemble()
    A_full = a.assemble_matrix()
    nL, nC = fes.ndof_scalar, sp.ndof_conf
    rows, cols, vals = list(sp.L_of_conf), list(range(nC)), [1.0] * nC
    sm = np.asarray(sp._slave_masters)
    sw = np.asarray(sp._slave_w)
    si = np.asarray(sp._slave_idx)
    for i in range(len(si)):
        for j in range(sm.shape[1]):
            rows.append(int(si[i]))
            cols.append(int(sm[i, j]))
            vals.append(float(sw[i, j]))
    P = sp_.coo_matrix((vals, (rows, cols)), shape=(nL, nC)).tocsr()
    A_C_ref = (P.T @ A_full @ P).toarray()

    AC = sp.constrained_operator(A_L.mult)
    rng = np.random.default_rng(0)
    x = rng.random(nC)
    assert np.allclose(np.asarray(AC(jnp.asarray(x))), A_C_ref @ x,
                       atol=1e-11)
