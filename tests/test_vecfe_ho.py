"""Arbitrary-order ND/RT: orientation-robust dof identification and
operator-level exactness (the DofTransformation-equivalent machinery)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.basis import h1_nodes_1d
from cardiac_ablation_ecm2.fem.fe_vector_ho import (
    NDSpaceHO,
    RTSpaceHO,
    _nd_local_dofs,
    _open_nodes,
    _rt_local_dofs,
)
from cardiac_ablation_ecm2.fem.geometry import REF_VERTS, Geometry
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)


def _cube_rotations():
    """The 24 orientation-preserving vertex permutations of the hex."""
    rv = REF_VERTS[Geometry.CUBE] - 0.5
    mats = []
    axes = np.eye(3, dtype=int)
    for x in (0, 1, 2):
        for sx in (1, -1):
            for y in (0, 1, 2):
                if y == x:
                    continue
                for sy in (1, -1):
                    ex = sx * axes[x]
                    ey = sy * axes[y]
                    ez = np.cross(ex, ey)
                    mats.append(np.stack([ex, ey, ez], axis=1))
    perms = []
    vmap = {tuple(np.round(v, 6)): i for i, v in enumerate(rv)}
    for M in mats:
        im = rv @ M.T
        perm = [vmap[tuple(np.round(p, 6))] for p in im]
        perms.append(perm)
    uniq = sorted(set(map(tuple, perms)))
    assert len(uniq) == 24
    return [list(p) for p in uniq]


def _rotate_mesh(mesh, seed=0):
    """Relabel each hex's local vertex order by a random cube rotation —
    same geometry, maximally shuffled orientations."""
    rots = _cube_rotations()
    rng = np.random.default_rng(seed)
    elems = mesh.elements.copy()
    for e in range(mesh.ne):
        perm = rots[rng.integers(len(rots))]
        # new local vertex i holds the old vertex perm[i]:
        # connectivity row permuted so corner i sits at rotated position
        inv = np.argsort(perm)
        elems[e] = mesh.elements[e][inv]
    mesh2 = type(mesh)(
        geom=mesh.geom,
        vertices=mesh.vertices,
        elements=elems,
        attributes=mesh.attributes,
        boundary=mesh.boundary,
        bdr_attributes=mesh.bdr_attributes,
    )
    return mesh2


def _dof_points_dirs(space, mesh):
    """Physical dof coordinates + directions per (element, local dof)."""
    dim = mesh.dim
    k = space._k
    if space.kind == "nd":
        dofs = _nd_local_dofs(dim, k)
        opn, cls = _open_nodes(k), h1_nodes_1d(k)
        nodes = lambda d, a: opn if a == d else cls  # noqa: E731
    else:
        dofs = _rt_local_dofs(dim, k)
        opn, cls = _open_nodes(k + 1), h1_nodes_1d(k + 1)
        nodes = lambda d, a: cls if a == d else opn  # noqa: E731
    rv = REF_VERTS[mesh.geom]
    V = mesh.vertices
    ne = mesh.ne
    pts = np.zeros((ne, len(dofs), dim))
    dirs = np.zeros((ne, len(dofs), dim))
    for n, (d, idx) in enumerate(dofs):
        ref = np.array([nodes(d, a)[idx[a]] for a in range(dim)])
        # multilinear map of corners
        w = np.ones((ne, len(rv)))
        for a in range(dim):
            w = w * np.where(rv[None, :, a] > 0.5, ref[a], 1 - ref[a])
        pts[:, n] = np.einsum("ev,evs->es", w, V[mesh.elements])
        # direction: column d of the (corner-difference) Jacobian at ref pt
        e_d = np.zeros(dim)
        e_d[d] = 1e-4
        wp = np.ones((ne, len(rv)))
        for a in range(dim):
            c = ref[a] + e_d[a]
            wp = wp * np.where(rv[None, :, a] > 0.5, c, 1 - c)
        dirs[:, n] = np.einsum("ev,evs->es", wp, V[mesh.elements]) - pts[:, n]
        dirs[:, n] /= np.linalg.norm(dirs[:, n], axis=1, keepdims=True)
    return pts, dirs


@pytest.mark.parametrize("kind,order", [
    ("nd", 1), ("nd", 2), ("nd", 3), ("rt", 1), ("rt", 2), ("rt", 3),
])
def test_dof_identity_rotated_mesh(kind, order):
    """On a mesh with randomly rotated element connectivity, every global dof
    must resolve to ONE physical point, and signed directions must agree."""
    mesh = _rotate_mesh(make_cartesian_3d(2, 2, 2), seed=3)
    space = NDSpaceHO(mesh, order) if kind == "nd" else RTSpaceHO(mesh, order)
    pts, dirs = _dof_points_dirs(space, mesh)
    gm, sg = space.gather_map, space.signs

    seen_pt = {}
    seen_dir = {}
    for e in range(mesh.ne):
        for n in range(space.nd_elem):
            g = int(gm[e, n])
            p = np.round(pts[e, n], 9)
            v = np.round(sg[e, n] * dirs[e, n], 6)
            if g in seen_pt:
                assert np.array_equal(seen_pt[g], p), (kind, order, g)
                assert np.allclose(seen_dir[g], v, atol=1e-5), \
                    (kind, order, g, seen_dir[g], v)
            else:
                seen_pt[g] = p
                seen_dir[g] = v


@pytest.mark.parametrize("kind,order", [("nd", 2), ("rt", 2), ("nd", 3)])
def test_constant_field_reproduction(kind, order):
    """Mass-project a constant vector field on a rotated-connectivity mesh:
    the projection must reproduce it exactly at all quadrature points —
    fails if any sign/permutation in the continuity wiring is wrong."""
    from cardiac_ablation_ecm2.linalg.solvers import cg

    mesh = _rotate_mesh(make_cartesian_3d(2, 2, 2), seed=7)
    c = np.array([0.3, -1.1, 0.7])
    if kind == "nd":
        space = NDSpaceHO(mesh, order)
        op = build_nd_operator(space, mass_coeff=1.0, nq1d=order + 2)
    else:
        space = RTSpaceHO(mesh, order)
        op = build_rt_operator(space, mass_coeff=1.0, nq1d=order + 2)
    b = vecfe_linear_form(op, lambda x: np.broadcast_to(c, x.shape))
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=3000)
    # evaluate at quadrature points via the mass term's physical basis
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    assert np.abs(vals - c).max() < 1e-7, np.abs(vals - c).max()


def test_nd_gradient_has_zero_curl():
    """∇H1 ⊂ ND: project ∇(xyz-ish polynomial); curl-curl energy ≈ 0."""
    from cardiac_ablation_ecm2.linalg.solvers import cg

    mesh = _rotate_mesh(make_cartesian_3d(2, 2, 2), seed=1)
    order = 2
    space = NDSpaceHO(mesh, order)
    op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=None,
                           nq1d=order + 2)
    opc = build_nd_operator(space, mass_coeff=None, curlcurl_coeff=1.0,
                            nq1d=order + 2)

    def gradf(x):
        # ∇(x² y + z y): (2xy, x² + z, y)  — degree ≤ 2, in ND_2
        g = np.stack([
            2 * x[..., 0] * x[..., 1],
            x[..., 0] ** 2 + x[..., 2],
            x[..., 1],
        ], axis=-1)
        return g

    b = vecfe_linear_form(op, gradf)
    x, info = cg(op.mult, b, M=lambda r: r / op.diagonal(),
                 rel_tol=1e-13, max_iter=5000)
    curl_energy = float(jnp.vdot(x, opc.mult(x)))
    mass_energy = float(jnp.vdot(x, op.mult(x)))
    assert curl_energy < 1e-9 * mass_energy, (curl_energy, mass_energy)


def test_rt_2d_constant():
    from cardiac_ablation_ecm2.linalg.solvers import cg

    mesh = make_cartesian_2d(3, 3)
    space = RTSpaceHO(mesh, 2)
    op = build_rt_operator(space, mass_coeff=1.0, nq1d=4)
    c = np.array([0.4, -0.9])
    b = vecfe_linear_form(op, lambda x: np.broadcast_to(c, x.shape))
    x, _ = cg(op.mult, b, M=lambda r: r / op.diagonal(),
              rel_tol=1e-13, max_iter=2000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    assert np.abs(vals - c).max() < 1e-8


def test_nd_2d_constant():
    from cardiac_ablation_ecm2.linalg.solvers import cg

    mesh = make_cartesian_2d(3, 3)
    space = NDSpaceHO(mesh, 2)
    op = build_nd_operator(space, mass_coeff=1.0, nq1d=4)
    c = np.array([-0.2, 0.8])
    b = vecfe_linear_form(op, lambda x: np.broadcast_to(c, x.shape))
    x, _ = cg(op.mult, b, M=lambda r: r / op.diagonal(),
              rel_tol=1e-13, max_iter=2000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    assert np.abs(vals - c).max() < 1e-8


def test_matrix_coefficient_mass():
    """ex31-class anisotropic (σE, F): constant-field energy = cᵀσc·vol and
    FULL-assembly cross-check (VectorFEMassIntegrator w/ MatrixCoefficient,
    fem/bilininteg.hpp:2704)."""
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form

    sig = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.1], [0.0, 0.1, 3.0]])
    mesh = make_cartesian_3d(2, 2, 2)
    sp = NDSpaceHO(mesh, 2)
    A = build_nd_operator(sp, mass_coeff=sig, curlcurl_coeff=1.0, nq1d=4)
    c = np.array([1.0, -0.5, 0.7])
    M1 = build_nd_operator(sp, mass_coeff=1.0, nq1d=4)
    b = vecfe_linear_form(M1, lambda x: np.broadcast_to(sig @ c, x.shape))
    u, info = cg(A.mult, b, M=lambda r: r / A.diagonal(),
                 rel_tol=1e-13, max_iter=4000)
    assert bool(info.converged)
    exact = float(c @ sig @ c)
    assert np.isclose(float(u @ b), exact, rtol=1e-8)
    Am = A.assemble_matrix()
    x = np.random.default_rng(0).standard_normal(A.ndof)
    assert np.allclose(Am @ x, np.asarray(A.mult(jnp.asarray(x))),
                       atol=1e-11)
    # spatially varying matrix coefficient path
    def sigf(x):
        s = 1.0 + x[..., 0]
        out = np.zeros(x.shape[:-1] + (3, 3))
        for i in range(3):
            out[..., i, i] = s
        return out

    Av = build_nd_operator(sp, mass_coeff=sigf, nq1d=4)
    Avm = Av.assemble_matrix()
    assert np.allclose(Avm @ x, np.asarray(Av.mult(jnp.asarray(x))),
                       atol=1e-11)
