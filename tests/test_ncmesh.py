"""Nonconforming 2:1 quad AMR: constraint detection, conforming-projection
exactness through hanging nodes, PᵀAP cross-check, and an adaptive Poisson
loop (ex6 on quads — the NCMesh analog)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for, restriction_for
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.mesh.ncmesh import make_nc, refine_quads
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def refined_nc(marks_fn=None, n=4, rounds=1):
    nc = make_nc(make_cartesian_2d(n, n))
    for _r in range(rounds):
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        if marks_fn is None:
            # nested corner refinement: guaranteed persistent hanging nodes
            marks = (cent[:, 0] < 0.5 ** (_r + 1)) & (cent[:, 1] < 0.5 ** (_r + 1))
        else:
            marks = marks_fn(cent)
        nc, _ = refine_quads(nc, marks)
    return nc


def test_constraints_detected():
    nc = refined_nc()
    assert nc.n_hanging > 0
    # every hanging vertex is the bit-exact midpoint of its masters
    for (v, a, b) in nc.constraints:
        mid = 0.5 * (nc.mesh.vertices[a] + nc.mesh.vertices[b])
        assert np.array_equal(mid, nc.mesh.vertices[v])


@pytest.mark.parametrize("p", [1, 2, 3])
def test_conforming_projection_exact(p):
    """Project a degree-p polynomial onto the conforming dofs; after
    prolongation the broken field must equal the polynomial at all quad
    points — continuity across hanging nodes is exactly enforced."""
    nc = refined_nc(rounds=2)
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


def test_ptap_matches_scipy(p=2):
    """Matrix-free PᵀAP == scipy Pᵀ A P on the assembled matrix."""
    import scipy.sparse as sp_

    nc = refined_nc()
    sp = NCFESpace(nc, p)
    fes = sp.fes
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A_L = a.assemble()
    A_full = a.assemble_matrix()
    # build P as scipy
    nL, nC = fes.ndof_scalar, sp.ndof_conf
    rows, cols, vals = list(sp.L_of_conf), list(range(nC)), [1.0] * nC
    sm = np.asarray(sp._slave_masters)
    sw = np.asarray(sp._slave_w)
    si = np.asarray(sp._slave_idx)
    for i in range(len(si)):
        for j in range(sm.shape[1]):
            rows.append(int(si[i])); cols.append(int(sm[i, j]))
            vals.append(float(sw[i, j]))
    P = sp_.coo_matrix((vals, (rows, cols)), shape=(nL, nC)).tocsr()
    A_C_ref = (P.T @ A_full @ P).toarray()

    AC = sp.constrained_operator(A_L.mult)
    rng = np.random.default_rng(0)
    x = rng.random(nC)
    y1 = np.asarray(AC(jnp.asarray(x)))
    y2 = A_C_ref @ x
    assert np.allclose(y1, y2, atol=1e-11), np.abs(y1 - y2).max()


def test_nc_poisson_adaptive_loop():
    """ex6-on-quads: NC-AMR Poisson beats uniform at comparable dofs on the
    corner-singular L-shape problem."""
    from test_amr import lshape_mesh, u_singular  # reuse singular solution
    from cardiac_ablation_ecm2.fem.estimators import zz_estimator
    from cardiac_ablation_ecm2.mesh import Mesh
    from cardiac_ablation_ecm2.fem.geometry import Geometry

    # L-shaped quad mesh
    full = make_cartesian_2d(4, 4, 2.0, 2.0)
    verts = full.vertices - 1.0
    cent = verts[full.elements].mean(axis=1)
    keep = ~((cent[:, 0] > 0) & (cent[:, 1] < 0))
    elems = full.elements[keep]
    used = np.unique(elems)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    from collections import Counter

    edges = Counter()
    for t in remap[elems]:
        for i in range(4):
            a, b = int(t[i]), int(t[(i + 1) % 4])
            edges[tuple(sorted((a, b)))] += 1
    bdr = np.array([e for e, c in edges.items() if c == 1], dtype=np.int64)
    mesh0 = Mesh(
        geom=Geometry.SQUARE, vertices=verts[used], elements=remap[elems],
        attributes=np.ones(keep.sum(), dtype=np.int64), boundary=bdr,
        bdr_attributes=np.ones(len(bdr), dtype=np.int64),
    )

    def solve_nc(nc, p=2):
        sp = NCFESpace(nc, p)
        fes = sp.fes
        A_L = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
        ess = jnp.asarray(sp.essential_dofs())
        xb = jnp.asarray(u_singular(sp.dof_coords))

        def AC(x):
            z = x.at[ess].set(0.0)
            y = sp.restrict_t(A_L.mult(sp.prolongate(z)))
            return y.at[ess].set(x[ess])

        b = jnp.zeros(sp.ndof_conf)
        w = jnp.zeros(sp.ndof_conf).at[ess].set(xb[ess])
        b = -sp.restrict_t(A_L.mult(sp.prolongate(w)))
        b = b.at[ess].set(xb[ess])
        x, info = cg(AC, b, rel_tol=1e-11, max_iter=4000)
        assert bool(info.converged)
        uL = sp.prolongate(x)
        from cardiac_ablation_ecm2.fem.gridfunction import l2_error

        return sp, uL, float(l2_error(fes, uL, u_singular))

    nc = make_nc(mesh0)
    for _ in range(3):
        sp, uL, err = solve_nc(nc)
        eta = zz_estimator(sp.fes, uL)
        cent = nc.mesh.vertices[nc.mesh.elements].mean(axis=1)
        marks = eta > 0.4 * eta.max()
        nc, _ = refine_quads(nc, marks)
    sp, uL, err_a = solve_nc(nc)
    ndof_a = sp.ndof_conf

    # uniform reference at comparable dof count
    mesh_u = mesh0
    while True:
        fes_u = FESpace(mesh_u, 2)
        if fes_u.ndof_scalar >= ndof_a:
            break
        mesh_u = mesh_u.uniform_refinement()
    from cardiac_ablation_ecm2.models import poisson
    from cardiac_ablation_ecm2.fem.gridfunction import l2_error

    res = poisson.solve(mesh_u, order=2, rhs=lambda x: 0 * np.asarray(x)[..., 0],
                        bc=u_singular, rel_tol=1e-11)
    err_u = float(l2_error(res.fes, res.u, u_singular))
    assert err_a < err_u, (err_a, err_u, ndof_a, res.fes.ndof_scalar)
