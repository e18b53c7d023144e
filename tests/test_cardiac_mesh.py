"""Cardiac-like unstructured benchmark meshes (mesh/cardiac.py).

Validates the geometry invariants the benchmark depends on (watertight
boundary, positive volumes, carved-notch volume) and that the FEM stack
solves on them (the BASELINE config-5 workload path)."""

import numpy as np

from cardiac_ablation_ecm2.mesh.cardiac import (
    make_cardiac_hex_mesh,
    make_cardiac_tet_mesh,
)


def _tet_volumes(m):
    v = m.vertices[m.elements]
    return np.einsum(
        "ij,ij->i",
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
        v[:, 3] - v[:, 0],
    ) / 6.0


def test_tet_mesh_invariants():
    m = make_cardiac_tet_mesh(10)
    vols = _tet_volumes(m)
    assert (vols > 0).all()
    block = 40.0 * 40.0 * 20.0
    notch = 2.0 / 3.0 * np.pi * 4.0**3
    assert abs(vols.sum() - (block - notch)) / block < 0.02
    # watertight: outward area vectors of the boundary sum to ~0
    tv = m.vertices[m.boundary]
    closure = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]).sum(axis=0)
    assert np.abs(closure).max() < 1e-9
    # all three attributes present (body / electrode / ground)
    assert set(np.unique(m.bdr_attributes)) == {1, 2, 3}
    # genuinely unstructured: irregular vertex valence
    val = np.bincount(m.elements.ravel(), minlength=m.nv)
    assert val.std() > 2.0


def test_hex_mesh_invariants():
    m = make_cardiac_hex_mesh(10)
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.build import geom_factors_for

    fes = FESpace(m, 1)
    gf = geom_factors_for(fes)
    assert float(np.asarray(gf.det).min()) > 0  # warp/jitter keeps validity
    assert set(np.unique(m.bdr_attributes)) == {1, 2, 3}
    # no uniform-qdata shortcut: element volumes genuinely vary
    ev = np.asarray(gf.wdet).sum(axis=1)
    assert ev.std() / ev.mean() > 0.05


def test_mfem_roundtrip():
    from cardiac_ablation_ecm2.io.mesh_io import (
        read_mfem_mesh,
        write_mfem_mesh,
    )

    m = make_cardiac_tet_mesh(6)
    s = write_mfem_mesh(m)
    m2 = read_mfem_mesh(s)
    assert m2.ne == m.ne and m2.nv == m.nv and m2.nbe == m.nbe
    assert np.allclose(m2.vertices, m.vertices)
    assert (m2.elements == m.elements).all()


def test_bioheat_solves_on_cardiac_tet():
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.mesh.cardiac import rf_source_q
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    m = make_cardiac_tet_mesh(8, lengths=(0.04, 0.04, 0.02),
                              electrode_radius=0.004)
    fes = FESpace(m, 2)
    q = rf_source_q(np.array([0.02, 0.02, 0.02]), sigma=0.003, power=2e7)
    op = BioheatOperator(fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
                         q_rf=lambda x: q(x), ess_bdr=[1, 2, 3],
                         rel_tol=1e-8, theta_form=True)
    assert op._lane is not None          # tets ride the lane-major path
    solver = ode.select("sdirk33")
    T = jnp.zeros(fes.ndof)
    t, dt = jnp.asarray(0.0), jnp.asarray(0.25)
    for _ in range(2):
        T, t = solver.step(op, T, t, dt)
    Tmax = float(T.max())
    assert 0.01 < Tmax < 50.0            # heating happened, stayed bounded
    assert np.isfinite(np.asarray(T)).all()
