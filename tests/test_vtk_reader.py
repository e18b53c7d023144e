"""Legacy VTK reader (mesh/mesh_readers.cpp:1178 analog) validated against
the paired MFEM-format files in the reference data corpus."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import geom_factors_for
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
from cardiac_ablation_ecm2.io.vtk_reader import read_vtk_mesh

DATA = "/root/reference/data"


def _vol(mesh, p):
    gf = geom_factors_for(FESpace(mesh, p))
    return float(jnp.sum(gf.wdet)), float(jnp.min(gf.det))


@pytest.mark.parametrize("name,p", [
    ("beam-tri", 1), ("beam-quad", 1), ("beam-tet", 1), ("beam-hex", 1),
    ("escher", 1), ("escher-p2", 2), ("fichera-q2", 2),
])
def test_vtk_matches_mfem_mesh(name, p):
    mv = read_vtk_mesh(f"{DATA}/{name}.vtk")
    mm = read_mfem_mesh(f"{DATA}/{name}.mesh")
    vv, dv = _vol(mv, p)
    vm, _ = _vol(mm, p)
    assert dv > 0.0
    assert abs(vv - vm) < 1e-10 * abs(vm)
    assert mv.ne == mm.ne


def test_vtk_wedge_orientation():
    mv = read_vtk_mesh(f"{DATA}/beam-wedge.vtk")
    vol, det = _vol(mv, 1)
    assert det > 0.0
    assert abs(vol - 4.0) < 1e-10


def test_vtk_boundary_generation():
    mv = read_vtk_mesh(f"{DATA}/beam-hex.vtk")
    # 8 hexes in a 8x1x1 beam: 8*4 side faces + 2 ends = 34
    assert mv.nbe == 34
    assert set(np.unique(mv.bdr_attributes)) == {1}


def test_vtk_curved_solve():
    """A Poisson solve runs end-to-end on a quadratic VTK mesh."""
    from cardiac_ablation_ecm2.models import poisson

    mesh = read_vtk_mesh(f"{DATA}/fichera-q2.vtk")
    res = poisson.solve(mesh, order=2, rel_tol=1e-10)
    assert res.converged
    assert np.isfinite(np.asarray(res.u)).all()


def test_order3_curved_mfem_meshes():
    """Order-3 legacy (Cubic) curved meshes: volumes match MFEM's own
    integration (golden values from an order-12 rule via libmfem) and all
    Jacobians stay positive."""
    golden = {"escher-p3": 6.49821385476, "fichera-q3": 7.00270342516}
    for name, gv in golden.items():
        m = read_mfem_mesh(f"{DATA}/{name}.mesh")
        assert m.nodes_order == 3
        vol, det = _vol(m, 3)
        assert det > 0.0, (name, det)
        assert abs(vol - gv) < 1e-9 * gv, (name, vol, gv)


def test_order3_nodes_conforming():
    """Shared-entity node coords agree across elements (decode consistency)."""
    from cardiac_ablation_ecm2.fem.restriction import ElementRestriction

    for name in ("escher-p3", "fichera-q3"):
        m = read_mfem_mesh(f"{DATA}/{name}.mesh")
        fes = FESpace(m, 3)
        r = ElementRestriction.for_space(fes)
        cnt = np.asarray(r.counts()).clip(1)
        for c in range(m.nodes.shape[2]):
            e = jnp.asarray(m.nodes[:, :, c])
            avg = r.mult(r.mult_transpose(e) / cnt)
            assert float(jnp.abs(e - avg).max()) < 1e-12
