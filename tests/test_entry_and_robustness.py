"""Driver-artifact and robustness coverage (VERDICT r1 weak-8):
- __graft_entry__.entry() jits and runs (single virtual device);
- mesh readers fail cleanly on malformed input;
- order-5 H1 convergence (nothing previously exercised p ≥ 5)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_graft_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    T, t = out
    jax.block_until_ready(T)
    assert np.isfinite(np.asarray(T)).all()
    assert float(t) > 0


@pytest.mark.parametrize("payload", [
    "",  # empty
    "MFEM mesh v1.0\n\ndimension\n2\n",                      # truncated
    "garbage header\n1 2 3",                                  # wrong header
    "MFEM mesh v1.0\ndimension\n2\nelements\n1\n1 3 0 1 2 99\n",  # bad ids
    "# vtk DataFile Version 3.0\nx\nASCII\nDATASET POLYDATA\n",   # wrong ds
])
def test_mesh_readers_reject_malformed(payload):
    from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
    from cardiac_ablation_ecm2.io.vtk_reader import read_vtk_mesh

    with pytest.raises(Exception):
        if payload.startswith("# vtk"):
            read_vtk_mesh(payload)
        else:
            m = read_mfem_mesh(payload)
            # a "successful" parse of garbage must still fail validation
            from cardiac_ablation_ecm2.fem import FESpace

            FESpace(m, 1)


def test_h1_order5_convergence():
    """Order-5 Poisson reproduces a degree-5 polynomial exactly (to solver
    tolerance) — exercises the p≥5 basis/dof paths end to end."""
    from cardiac_ablation_ecm2.fem.gridfunction import l2_error
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d
    from cardiac_ablation_ecm2.models import poisson

    def u_ex(x):
        x = np.asarray(x)
        return x[..., 0] ** 5 + x[..., 1] ** 5

    def f(x):
        x = np.asarray(x)
        return -20.0 * (x[..., 0] ** 3 + x[..., 1] ** 3)

    mesh = make_cartesian_2d(3, 3)
    res = poisson.solve(mesh, order=5, rhs=f, bc=u_ex, rel_tol=1e-13,
                        max_iter=5000)
    assert res.converged
    err = float(l2_error(res.fes, res.u, u_ex))
    assert err < 1e-9, err
