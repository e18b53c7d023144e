"""AMR loop (ex6 analog): NVB bisection conformity, ZZ estimator sanity,
point evaluation, and adaptive beats uniform on the L-shaped singularity."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.estimators import zz_estimator
from cardiac_ablation_ecm2.fem.gridfunction import l2_error, project
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d_tri
from cardiac_ablation_ecm2.mesh.amr import (
    bisect_marked,
    interp_after_refine,
    threshold_refine,
)
from cardiac_ablation_ecm2.mesh.point_eval import evaluate_at_points
from cardiac_ablation_ecm2.fem.geometry import Geometry
from cardiac_ablation_ecm2.models import poisson


def lshape_mesh():
    """L-shaped domain (-1,1)² minus the fourth quadrant, triangulated."""
    full = make_cartesian_2d_tri(4, 4, 2.0, 2.0)
    verts = full.vertices - 1.0
    cent = verts[full.elements].mean(axis=1)
    keep = ~((cent[:, 0] > 0) & (cent[:, 1] < 0))
    elems = full.elements[keep]
    used = np.unique(elems)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    elems = remap[elems]
    v = verts[used]
    # rebuild boundary: edges appearing once
    from collections import Counter

    edges = Counter()
    for t in elems:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges[tuple(sorted((a, b)))] += 1
    bdr = np.array([e for e, c in edges.items() if c == 1], dtype=np.int64)
    return Mesh(
        geom=Geometry.TRIANGLE,
        vertices=v,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=bdr,
        bdr_attributes=np.ones(len(bdr), dtype=np.int64),
    )


def u_singular(x):
    """r^(2/3) sin(2θ/3) — the re-entrant corner solution (Δu = 0)."""
    x = np.asarray(x)
    r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = np.arctan2(x[..., 1], x[..., 0])
    th = np.where(th < 0, th + 2 * np.pi, th)   # θ ∈ [0, 2π), corner at 0
    return r ** (2.0 / 3.0) * np.sin(2.0 * th / 3.0)


def test_bisection_conforming():
    mesh = make_cartesian_2d_tri(2, 2)
    rng = np.random.default_rng(0)
    m = mesh
    for it in range(3):
        marks = rng.random(m.ne) > 0.5
        m, parent = bisect_marked(m, marks)
        # conformity: every interior edge shared by exactly 2 elements
        from collections import Counter

        edges = Counter()
        for t in m.elements:
            for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                edges[tuple(sorted((int(a), int(b))))] += 1
        assert all(c <= 2 for c in edges.values())
        # area preserved
        v = m.vertices
        p = v[m.elements]
        area = 0.5 * np.abs(
            (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
        ).sum()
        assert np.isclose(area, 1.0), area
        # a dof-numbering build must succeed (catches broken connectivity)
        FESpace(m, 2)


def test_point_evaluation():
    mesh = make_cartesian_2d_tri(4, 4)
    fes = FESpace(mesh, 2)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 + 2 * x[..., 1]

    u = project(fes, f)
    pts = np.array([[0.33, 0.41], [0.77, 0.12], [0.5, 0.5], [0.001, 0.999]])
    vals = evaluate_at_points(fes, np.asarray(u), pts)
    assert np.allclose(vals, f(pts), atol=1e-11)


def test_zz_estimator_flags_singularity():
    mesh = lshape_mesh()
    res = poisson.solve(mesh, order=1, rhs=lambda x: 0 * np.asarray(x)[..., 0],
                        bc=u_singular, rel_tol=1e-12)
    eta = zz_estimator(res.fes, res.u)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    r = np.linalg.norm(cent, axis=1)
    # the largest estimate should sit at the re-entrant corner
    assert r[np.argmax(eta)] < 0.5, (r[np.argmax(eta)], eta.max())


def test_amr_beats_uniform_on_lshape():
    """ex6-style loop: adaptive refinement reaches lower error than uniform
    at comparable dof count."""
    zero = lambda x: 0 * np.asarray(x)[..., 0]

    # adaptive
    mesh = lshape_mesh()
    for it in range(6):
        res = poisson.solve(mesh, order=1, rhs=zero, bc=u_singular,
                            rel_tol=1e-12)
        eta = zz_estimator(res.fes, res.u)
        mesh, parent, any_ref = threshold_refine(mesh, eta, frac=0.5)
        if not any_ref:
            break
    res_a = poisson.solve(mesh, order=1, rhs=zero, bc=u_singular, rel_tol=1e-12)
    err_a = float(l2_error(res_a.fes, res_a.u, u_singular))
    ndof_a = res_a.fes.ndof_scalar

    # uniform with at least as many dofs
    mesh_u = lshape_mesh()
    while True:
        fes_u = FESpace(mesh_u, 1)
        if fes_u.ndof_scalar >= ndof_a:
            break
        mesh_u = mesh_u.uniform_refinement()
    res_u = poisson.solve(mesh_u, order=1, rhs=zero, bc=u_singular,
                          rel_tol=1e-12)
    err_u = float(l2_error(res_u.fes, res_u.u, u_singular))
    assert err_a < err_u, (err_a, err_u, ndof_a, res_u.fes.ndof_scalar)


def test_solution_transfer():
    mesh = make_cartesian_2d_tri(3, 3)
    fes = FESpace(mesh, 2)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] * x[..., 1] + x[..., 1] ** 2

    u = project(fes, f)
    mesh2, parent = bisect_marked(mesh, np.ones(mesh.ne, dtype=bool))
    fes2 = FESpace(mesh2, 2)
    u2 = interp_after_refine(fes, fes2, u)
    u2_direct = project(fes2, f)
    assert np.allclose(np.asarray(u2), np.asarray(u2_direct), atol=1e-10)


def test_kelly_estimator_flags_singularity():
    from cardiac_ablation_ecm2.fem.estimators import kelly_estimator

    mesh = lshape_mesh()
    res = poisson.solve(mesh, order=2, rhs=lambda x: 0 * np.asarray(x)[..., 0],
                        bc=u_singular, rel_tol=1e-12)
    eta = kelly_estimator(res.fes, res.u)
    cent = mesh.vertices[mesh.elements].mean(axis=1)
    r = np.linalg.norm(cent, axis=1)
    assert r[np.argmax(eta)] < 0.5, (r[np.argmax(eta)], eta.max())


def test_attribute_sets():
    from cardiac_ablation_ecm2.mesh.attribute_sets import (
        AttributeSets,
        resolve_marker,
    )
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d

    s = AttributeSets()
    s.set("walls", [1, 3])
    s.add_to("walls", [4])
    s.set("inlet", [2])
    assert s.get("walls") == [1, 3, 4]
    assert s.union("walls", "inlet") == [1, 2, 3, 4]
    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2)
    ess = fes.essential_dofs(resolve_marker("inlet", s))
    assert np.allclose(fes.dof_coords[ess][:, 0], 1.0)   # x=1 side
