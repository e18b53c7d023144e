"""Nonconforming (hanging-node) tet AMR (NCMesh-on-tets analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.build import (
    basis_for,
    geom_factors_for,
    restriction_for,
)
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d_tet
from cardiac_ablation_ecm2.mesh.nctet import make_nc_tet, refine_tets_nc
from cardiac_ablation_ecm2.ops import BilinearForm


def _refined(rounds=1, seed_marks=None):
    nc = make_nc_tet(make_cartesian_3d_tet(2, 2, 2))
    for r in range(rounds):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        marks = (np.linalg.norm(cent, axis=1) < 0.6 / (r + 1)
                 if seed_marks is None else seed_marks(cent))
        nc, _ = refine_tets_nc(nc, marks)
    return nc


def test_refinement_integrity():
    nc = _refined()
    assert nc.n_hanging > 0
    p = nc.mesh.vertices[nc.mesh.elements]
    vols = np.linalg.det(p[:, 1:] - p[:, :1]) / 6
    assert np.all(vols > 0)                      # orientation preserved
    assert np.isclose(vols.sum(), 1.0, atol=1e-12)
    for (v, a, b) in nc.constraints:
        mid = 0.5 * (nc.mesh.vertices[a] + nc.mesh.vertices[b])
        assert np.array_equal(mid, nc.mesh.vertices[v])


def test_two_to_one_balance():
    """Refining the same corner twice forces the neighbors (no edge may
    carry both a midpoint and a quarter-point)."""
    from cardiac_ablation_ecm2.mesh.nctet import _overrefined_edges

    nc = _refined(rounds=2)
    assert not _overrefined_edges(nc.mesh)


def test_conforming_projection_and_ptap():
    import scipy.sparse as ssp

    nc = _refined()
    sp = NCFESpace(nc, 1)
    assert sp.n_slaves == nc.n_hanging
    f = lambda x: (1.0 + 2 * np.asarray(x)[..., 0]
                   - np.asarray(x)[..., 1] + 0.5 * np.asarray(x)[..., 2])
    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.abs(np.asarray(uq) - f(np.asarray(gf.x))).max() < 1e-12

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
    P = ssp.coo_matrix((vals, (rows, cols)), shape=(nL, nC)).tocsr()
    ref = (P.T @ A_full @ P).toarray()
    AC = sp.constrained_operator(A_L.mult)
    x = np.random.default_rng(0).standard_normal(nC)
    assert np.abs(np.asarray(AC(jnp.asarray(x))) - ref @ x).max() < 1e-11


def test_nc_tet_poisson_adaptive():
    """Two NC refinement rounds reduce the Poisson error monotonically."""
    def solve(nc):
        sp = NCFESpace(nc, 1)
        fes = sp.fes
        A_L = BilinearForm(fes).add_domain_integrator(
            "diffusion").assemble()
        from cardiac_ablation_ecm2.ops.linearform import domain_lf

        k2 = 3 * np.pi ** 2
        f = lambda x: k2 * np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)
        exact = lambda x: np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)
        b = sp.restrict_t(domain_lf(fes, f))
        ess = jnp.asarray(sp.essential_dofs())
        m = jnp.ones(sp.ndof_conf).at[ess].set(0.0)
        AC = lambda v: sp.restrict_t(
            A_L.mult(sp.prolongate(v * m))) * m + v * (1 - m)
        u, info = cg(AC, b * m, rel_tol=1e-10, max_iter=4000)
        assert bool(info.converged)
        from cardiac_ablation_ecm2.fem.gridfunction import l2_error

        return float(l2_error(fes, sp.prolongate(u), exact))

    nc = make_nc_tet(make_cartesian_3d_tet(2, 2, 2))
    e0 = solve(nc)
    cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
    nc, _ = refine_tets_nc(
        nc, np.abs(cent - 0.5).max(axis=1) < 0.3)
    e1 = solve(nc)
    assert e1 < e0, (e0, e1)


def test_order2_slave_count_and_quadratic_exactness():
    """p=2 NC tets (VERDICT r2 item 5): every refined master tri face adds
    3 medial-edge slave nodes beyond the edge machinery, and the conforming
    interpolant of a QUADRATIC is reproduced exactly at every broken dof —
    wrong P2-trace weights would corrupt the slave values."""
    nc = _refined()
    assert len(nc.tri_face_constraints) > 0
    sp1 = NCFESpace(nc, 1)
    sp2 = NCFESpace(nc, 2)
    assert sp2.n_slaves >= sp1.n_slaves + 3 * len(nc.tri_face_constraints)

    def f(x):
        x = np.asarray(x)
        return (0.3 + x[..., 0] - 2 * x[..., 1] + 0.5 * x[..., 2]
                + x[..., 0] * x[..., 1] - x[..., 1] * x[..., 2]
                + 0.25 * x[..., 0] ** 2 + x[..., 2] ** 2)

    uc = jnp.asarray(f(sp2.dof_coords))
    uL = sp2.prolongate(uc)
    all_coords = np.zeros((sp2.fes.ndof_scalar, 3))
    gm = sp2.fes.gather_map.astype(np.int64)
    from cardiac_ablation_ecm2.fem.fespace import element_node_coords

    X = element_node_coords(nc.mesh, 2)
    all_coords[gm.reshape(-1)] = X.reshape(-1, 3)
    assert np.abs(np.asarray(uL) - f(all_coords)).max() < 1e-12


def test_order2_ptap_matches_scipy():
    import scipy.sparse as ssp

    nc = _refined()
    sp = NCFESpace(nc, 2)
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
    P = ssp.coo_matrix((vals, (rows, cols)), shape=(nL, nC)).tocsr()
    ref = (P.T @ A_full @ P).toarray()
    AC = sp.constrained_operator(A_L.mult)
    x = np.random.default_rng(1).standard_normal(nC)
    assert np.abs(np.asarray(AC(jnp.asarray(x))) - ref @ x).max() < 1e-10


def test_nc_tet_poisson_adaptive_order2():
    """Adaptive p=2 NC tet Poisson: the cardiac combination (VERDICT r2).
    Error drops under NC refinement and beats p=1 on the same forest."""
    def solve(nc, p):
        sp = NCFESpace(nc, p)
        fes = sp.fes
        A_L = BilinearForm(fes).add_domain_integrator(
            "diffusion").assemble()
        from cardiac_ablation_ecm2.ops.linearform import domain_lf

        k2 = 3 * np.pi ** 2
        f = lambda x: k2 * np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)
        exact = lambda x: np.prod(np.sin(np.pi * np.asarray(x)), axis=-1)
        b = sp.restrict_t(domain_lf(fes, f))
        ess = jnp.asarray(sp.essential_dofs())
        m = jnp.ones(sp.ndof_conf).at[ess].set(0.0)
        AC = lambda v: sp.restrict_t(
            A_L.mult(sp.prolongate(v * m))) * m + v * (1 - m)
        u, info = cg(AC, b * m, rel_tol=1e-10, max_iter=6000)
        assert bool(info.converged)
        from cardiac_ablation_ecm2.fem.gridfunction import l2_error

        return float(l2_error(fes, sp.prolongate(u), exact))

    nc0 = make_nc_tet(make_cartesian_3d_tet(2, 2, 2))
    e0 = solve(nc0, 2)
    # near-uniform refinement with an NC pocket left at one corner: the
    # p=2 L2 rate is h^3, so the error should drop ~6-8x
    cent = nc0.mesh.vertices[nc0.mesh.elements].mean(axis=1)
    nc1, _ = refine_tets_nc(nc0, ~(cent.min(axis=1) > 0.5))
    assert len(nc1.tri_face_constraints) > 0
    e1 = solve(nc1, 2)
    e1_p1 = solve(nc1, 1)
    assert e1 < 0.55 * e0, (e0, e1)
    assert e1 < e1_p1, (e1, e1_p1)


@pytest.mark.parametrize("p", [3, 4])
def test_high_order_tri_face_exactness(p):
    """NC tets at order ≥ 3 (round-3 verdict item 6): the full P_p trace
    interpolation — medial-edge AND child-face-interior slaves — must
    reproduce degree-p polynomials exactly through hanging tri faces."""
    nc = _refined()
    assert len(nc.tri_face_constraints) > 0
    sp = NCFESpace(nc, p)
    sp2 = NCFESpace(nc, 2)
    assert sp.n_slaves > sp2.n_slaves

    def f(x):
        x = np.asarray(x)
        out = (0.3 + x[..., 0] - 2 * x[..., 1] + 0.5 * x[..., 2]
               + x[..., 0] * x[..., 1] ** (p - 1)
               + 0.25 * x[..., 0] ** p + x[..., 2] ** 2
               - x[..., 1] * x[..., 2] ** (p - 1))
        return out

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-9)
