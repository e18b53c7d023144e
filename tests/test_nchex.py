"""Nonconforming 2:1 hex AMR: constraint detection (edge + face hangers),
conforming-projection exactness through hanging faces, PᵀAP cross-check,
and 2:1 balance propagation (the 3D NCMesh analog, ncmesh.hpp:189)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import (
    basis_for,
    geom_factors_for,
    restriction_for,
)
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.mesh.ncmesh import make_nc, refine_hexes
from cardiac_ablation_ecm2.ops import BilinearForm


def refined_nc(n=2, rounds=1):
    nc = make_nc(make_cartesian_3d(n, n, n))
    for r in range(rounds):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        marks = (cent < 0.5 ** (r + 1)).all(axis=1)
        nc, _ = refine_hexes(nc, marks)
    return nc


def test_constraints_detected():
    nc = refined_nc()
    assert len(nc.face_constraints) == 3      # 3 interior faces of the corner hex
    assert len(nc.constraints) > 0            # edge hangers
    verts = nc.mesh.vertices
    for (v, a, b) in nc.constraints:
        assert np.array_equal(0.5 * (verts[a] + verts[b]), verts[v])
    for (c, A, B, C, D) in nc.face_constraints:
        ctr = verts[sorted((A, B, C, D))].mean(axis=0)
        assert np.allclose(ctr, verts[c], atol=1e-14)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_conforming_projection_exact(p):
    """Degree-p polynomial through hanging faces/edges: after prolongation
    the broken field equals the polynomial at all quad points."""
    nc = refined_nc()
    sp = NCFESpace(nc, p)
    assert sp.n_slaves > 0

    def f(x):
        x = np.asarray(x)
        out = x[..., 0] ** p + 0.3 * x[..., 1] - 0.7 * x[..., 2]
        if p >= 2:
            out = out + x[..., 0] * x[..., 1] ** (p - 1) + x[..., 1] * x[..., 2]
        return out

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_two_level_balance():
    """Nested corner refinement: balance propagation keeps interfaces 2:1 and
    projection stays exact."""
    nc = refined_nc(rounds=2)
    sp = NCFESpace(nc, 2)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] * x[..., 1] + x[..., 2] ** 2

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_ptap_matches_scipy():
    import scipy.sparse as sps

    p = 2
    nc = refined_nc()
    sp = NCFESpace(nc, p)
    fes = sp.fes
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A_L = a.assemble()
    A_full = a.assemble_matrix()
    nL, nC = fes.ndof_scalar, sp.ndof_conf
    rows = list(sp.L_of_conf)
    cols = list(range(nC))
    vals = [1.0] * nC
    sm = np.asarray(sp._slave_masters)
    sw = np.asarray(sp._slave_w)
    sidx = np.asarray(sp._slave_idx)
    for i in range(len(sidx)):
        for j in range(sm.shape[1]):
            if sw[i, j] != 0.0:
                rows.append(int(sidx[i]))
                cols.append(int(sm[i, j]))
                vals.append(float(sw[i, j]))
    P = sps.csr_matrix((vals, (rows, cols)), shape=(nL, nC))
    Ac_ref = (P.T @ A_full @ P).toarray()

    Ac = sp.constrained_operator(A_L.mult)
    I = np.eye(nC)
    Ac_mat = np.column_stack(
        [np.asarray(Ac(jnp.asarray(I[:, k]))) for k in range(nC)]
    )
    assert np.abs(Ac_mat - Ac_ref).max() < 1e-8


def test_nc_poisson_linear_exact():
    """-Δu = 0 with Dirichlet from a linear field: the NC-conforming solve
    must reproduce the linear solution exactly."""
    nc = refined_nc()
    sp = NCFESpace(nc, 2)
    fes = sp.fes
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A_L = a.assemble()
    Ac = sp.constrained_operator(A_L.mult)

    u_exact = jnp.asarray(
        1.0 + 2.0 * sp.dof_coords[:, 0]
        - 0.5 * sp.dof_coords[:, 1] + 0.25 * sp.dof_coords[:, 2]
    )
    ess = sp.essential_dofs(None)
    mask = np.zeros(sp.ndof_conf)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        xi = x * (1 - mask)
        y = Ac(xi)
        return y * (1 - mask) + x * mask

    b = -Ac(u_exact * mask) * (1 - mask) + u_exact * mask
    x, info = cg(Aop, b, rel_tol=1e-13, max_iter=500)
    assert np.abs(np.asarray(x - u_exact)).max() < 1e-8