"""Conforming longest-edge tet bisection (adaptive tet AMR — the
conforming-counterpart of the reference's NC tet refinement, SURVEY §7
hard-part 4 re-scope)."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh.amr import bisect_marked_tets
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_3d_tet
from cardiac_ablation_ecm2.ops import BilinearForm


def _conforming(mesh):
    """Every tri face is shared by ≤2 tets; single-count faces == the
    boundary list (as sorted triples)."""
    from collections import Counter

    from cardiac_ablation_ecm2.fem.geometry import FACES

    faces = Counter()
    for t in mesh.elements:
        for f in FACES[mesh.geom]:
            faces[tuple(sorted(int(t[v]) for v in f))] += 1
    if faces and max(faces.values()) > 2:
        return False, "face shared by >2 tets"
    single = {f for f, c in faces.items() if c == 1}
    bset = {tuple(sorted(int(v) for v in b)) for b in mesh.boundary}
    return single == bset, (len(single), len(bset))


def _volumes(mesh):
    p = mesh.vertices[mesh.elements]
    return np.linalg.det(p[:, 1:] - p[:, :1]) / 6.0


def test_single_round_conforming():
    mesh = make_cartesian_3d_tet(2, 2, 2)
    rng = np.random.default_rng(0)
    marks = rng.random(mesh.ne) < 0.3
    m2, parent = bisect_marked_tets(mesh, marks)
    assert m2.ne > mesh.ne
    ok, info = _conforming(m2)
    assert ok, info
    assert np.all(parent >= 0) and np.all(parent < mesh.ne)
    v0, v2 = _volumes(mesh), _volumes(m2)
    assert np.all(v2 > 0)
    assert np.isclose(v2.sum(), v0.sum(), rtol=1e-12)


def test_repeated_rounds_stay_conforming_and_shaped():
    mesh = make_cartesian_3d_tet(2, 2, 2)
    rng = np.random.default_rng(1)
    for r in range(4):
        cent = mesh.vertices[mesh.elements].mean(axis=1)
        marks = np.linalg.norm(cent, axis=1) < 0.7   # corner refinement
        mesh, _ = bisect_marked_tets(mesh, marks)
        ok, info = _conforming(mesh)
        assert ok, (r, info)
    v = _volumes(mesh)
    assert np.all(v > 0)
    # shape quality: bounded degeneracy (longest-edge bisection families)
    p = mesh.vertices[mesh.elements]
    edge_len = max(
        np.linalg.norm(p[:, i] - p[:, j], axis=1).max()
        for i in range(4) for j in range(i + 1, 4))
    rho = (6 * v) ** (1 / 3) / edge_len
    assert rho.min() > 0.05, rho.min()


def test_fespace_solves_on_refined_tets():
    """Order-2 H1 space on the bisected mesh: linear field annihilation
    (validates connectivity, orientations, and dof wiring end-to-end)."""
    mesh = make_cartesian_3d_tet(2, 2, 2)
    rng = np.random.default_rng(2)
    mesh, _ = bisect_marked_tets(mesh, rng.random(mesh.ne) < 0.4)
    fes = FESpace(mesh, 2)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    X = fes.dof_coords
    lin = jnp.asarray(1.0 + X[:, 0] - 2 * X[:, 1] + 0.5 * X[:, 2])
    r = np.asarray(A.mult(lin))
    ess = fes.essential_dofs()
    mask = np.ones(fes.ndof_scalar, bool)
    mask[ess] = False
    assert np.abs(r[mask]).max() < 1e-10
