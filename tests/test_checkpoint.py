"""Checkpoint/restart: save → load → continue must match uninterrupted run
(joule.cpp:563-575 restart pattern)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.io.checkpoint import (
    DataCollection,
    load_gridfunction,
    save_gridfunction,
)
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models import heat


def test_restart_bit_exact(tmp_path):
    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 2)
    op = heat.ConductionOperator(fes, kappa=0.3, alpha=0.1, rel_tol=1e-13)
    step = heat.make_stepper(op, ode.select("sdirk23"))

    u = jnp.asarray(np.random.default_rng(3).random(fes.ndof))
    t, dt = 0.0, 0.01

    # run 4 steps straight
    u_ref, t_ref = u, t
    for _ in range(4):
        u_ref, t_ref = step(u_ref, t_ref, dt)

    # run 2 steps, checkpoint, reload, run 2 more
    dc = DataCollection(path=str(tmp_path / "dc"), mesh=mesh)
    u2, t2 = u, t
    for i in range(2):
        u2, t2 = step(u2, t2, dt)
    dc.register_field("temperature", fes, u2)
    dc.set_time(float(t2), dt, cycle=2)
    dc.save(write_vtu=True)

    dc2 = DataCollection(path=str(tmp_path / "dc"), mesh=mesh)
    dc2.register_field("temperature", fes, None)
    dc2.fes_map["temperature"] = fes
    assert dc2.latest_cycle() == 2
    dc2.load(2)
    u3 = dc2.fields["temperature"]
    t3 = dc2.time
    assert t3 == float(t2)
    for _ in range(2):
        u3, t3 = step(u3, t3, dt)

    assert np.array_equal(np.asarray(u3), np.asarray(u_ref))  # bit-exact


def test_gridfunction_roundtrip(tmp_path):
    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 3)
    u = jnp.asarray(np.random.default_rng(0).random(fes.ndof))
    fn = str(tmp_path / "u.npz")
    save_gridfunction(fn, fes, u)
    u2, order, vdim = load_gridfunction(fn)
    assert order == 3 and vdim == 1
    assert np.array_equal(np.asarray(u), np.asarray(u2))


def test_pvd_series(tmp_path):
    from cardiac_ablation_ecm2.io.vtu import write_pvd, write_vtu

    mesh = make_cartesian_2d(2, 2)
    entries = []
    for k, t in enumerate((0.0, 0.5, 1.0)):
        fn = str(tmp_path / f"s{k}.vtu")
        write_vtu(mesh, fn)
        entries.append((t, fn))
    pvd = str(tmp_path / "series.pvd")
    write_pvd(pvd, entries)
    text = open(pvd).read()
    assert text.count("<DataSet") == 3 and 'timestep="0.5"' in text


def test_domain_lf_vector():
    """(f, v) with constant f: sums to f·|Ω| per component."""
    from cardiac_ablation_ecm2.ops.linearform import domain_lf_vector

    mesh = make_cartesian_2d(3, 3)
    fes = FESpace(mesh, 2, vdim=2)
    b = domain_lf_vector(fes, np.array([2.0, -3.0]))
    b2 = np.asarray(b).reshape(2, fes.ndof_scalar)
    assert np.isclose(b2[0].sum(), 2.0, atol=1e-12)
    assert np.isclose(b2[1].sum(), -3.0, atol=1e-12)


def test_visit_datacollection_roundtrip(tmp_path):
    """VisIt format (fem/datacollection.hpp:426 analog): root JSON + MFEM
    mesh + GridFunction files; roundtrips through our own loader and the
    GridFunction body is plain MFEM H1 P1 (reference-readable)."""
    import numpy as np

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.io.checkpoint import load_visit, save_visit
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d

    mesh = make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, 1)
    from cardiac_ablation_ecm2.fem.gridfunction import project

    f = lambda x: 1.0 + 2 * np.asarray(x)[..., 0] - np.asarray(x)[..., 2]
    u = project(fes, f)
    root = save_visit(str(tmp_path), "run", mesh, {"T": (fes, u)},
                      cycle=3, time=0.75)
    assert root.endswith("run_000003.mfem_root")
    m2, fields, meta = load_visit(root)
    assert m2.ne == mesh.ne and m2.nv == mesh.nv
    assert meta["cycle"] == 3 and abs(meta["time"] - 0.75) < 1e-15
    # values are in vertex order: compare against f at the vertices
    assert np.abs(fields["T"] - f(mesh.vertices)).max() < 1e-12
