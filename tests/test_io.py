"""Mesh I/O: read the reference's bundled corpus meshes and run the ex1
config on star.mesh (BASELINE.md config 1)."""

import os

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace, geom_factors_for
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh, write_mfem_mesh
from cardiac_ablation_ecm2.io.vtu import vertex_values, write_vtu
from cardiac_ablation_ecm2.models import poisson

DATA = "/root/reference/data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(DATA), reason="reference data not mounted"
)


def mesh_volume(mesh):
    fes = FESpace(mesh, 1)
    return float(np.sum(np.asarray(geom_factors_for(fes).wdet)))


def test_read_star():
    m = read_mfem_mesh(f"{DATA}/star.mesh")
    assert m.ne == 20 and m.dim == 2
    assert m.nbe > 0
    assert mesh_volume(m) > 0


@pytest.mark.parametrize(
    "name", ["inline-quad.mesh", "inline-hex.mesh", "beam-hex.mesh",
             "beam-quad.mesh", "beam-tet.mesh", "beam-tri.mesh",
             "fichera.mesh", "star.mesh"]
)
def test_read_corpus(name):
    m = read_mfem_mesh(f"{DATA}/{name}")
    assert m.ne > 0 and m.nv > 0
    v = mesh_volume(m)
    assert v > 0
    # roundtrip
    m2 = read_mfem_mesh(write_mfem_mesh(m))
    assert m2.ne == m.ne and np.allclose(m2.vertices, m.vertices)
    assert np.isclose(mesh_volume(m2), v)


def test_ex1_star_config(tmp_path):
    """BASELINE config 1: ex1 Poisson on star.mesh, H1 order 2, PCG+Jacobi."""
    m = read_mfem_mesh(f"{DATA}/star.mesh")
    res = poisson.solve(m, order=2, rhs=1.0, rel_tol=1e-12, max_iter=2000)
    assert res.converged
    # sanity: solution positive inside, zero on boundary
    ess = res.fes.essential_dofs()
    u = np.asarray(res.u)
    assert np.allclose(u[ess], 0.0)
    assert u.max() > 0
    # refinement increases accuracy monotonically toward a reference value
    m2 = m.uniform_refinement()
    res2 = poisson.solve(m2, order=2, rhs=1.0, rel_tol=1e-12, max_iter=4000)
    assert res2.converged
    # VTU export smoke test
    write_vtu(
        m, str(tmp_path / "star.vtu"),
        point_data={"u": vertex_values(res.fes, res.u)},
    )
    assert (tmp_path / "star.vtu").exists()


@pytest.mark.parametrize(
    "name,ne,vol",
    [
        # golden volumes from MFEM itself ((1,1) with an order-6 rule)
        ("escher-p2.mesh", 42, 6.386857624392391),
        ("square-disc-p2.mesh", 154, 0.8757701226560003),
    ],
)
def test_curved_mesh_volume_parity(name, ne, vol):
    """Order-2 curved meshes (nodes GridFunction) load with exact geometry:
    volumes match MFEM to 1e-13 relative."""
    m = read_mfem_mesh(f"{DATA}/{name}")
    assert m.ne == ne and m.nodes is not None and m.nodes_order == 2
    fes = FESpace(m, 2)
    v = float(np.sum(np.asarray(geom_factors_for(fes).wdet)))
    assert np.isclose(v, vol, rtol=1e-13), (v, vol)


GMSH_QUAD = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
1 7 "walls"
2 9 "domain"
$EndPhysicalNames
$Nodes
9
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
7 0 2 0
8 1 2 0
9 2 2 0
$EndNodes
$Elements
12
1 3 2 9 1 1 2 5 4
2 3 2 9 1 2 3 6 5
3 3 2 9 1 4 5 8 7
4 3 2 9 1 5 6 9 8
5 1 2 7 2 1 2
6 1 2 7 2 2 3
7 1 2 7 2 3 6
8 1 2 7 2 6 9
9 1 2 7 2 9 8
10 1 2 7 2 8 7
11 1 2 7 2 7 4
12 1 2 7 2 4 1
$EndElements
"""


def test_read_gmsh():
    """Gmsh 2.2 reader: quads + physical names + boundary selection."""
    from cardiac_ablation_ecm2.io.gmsh import read_gmsh

    m, names = read_gmsh(GMSH_QUAD)
    assert m.geom.name == "SQUARE" and m.ne == 4 and m.nbe == 8
    assert "walls" in names and "domain" in names
    assert np.isclose(mesh_volume(m), 4.0)
    fes = FESpace(m, 2)
    ess = fes.essential_dofs(names.get("walls"))
    assert len(ess) == 16   # perimeter of the 5x5 node grid


def test_gmsh_mixed_mesh_loads():
    """compass.msh is a mixed tri+quad mesh — loads as MixedMesh with one
    block per geometry (SURVEY §7 hard part 5, resolved)."""
    from cardiac_ablation_ecm2.fem.mixed import MixedMesh
    from cardiac_ablation_ecm2.io.gmsh import read_gmsh

    mesh, _names = read_gmsh(f"{DATA}/compass.msh")
    assert isinstance(mesh, MixedMesh)
    assert {str(int(g)) for g, _, _ in mesh.blocks} == {"2", "3"}  # tri+quad
    assert mesh.ne == 12 and mesh.nbe == 8


def test_vtkhdf_roundtrip(tmp_path):
    """VTKHDF (ParaViewHDFDataCollection analog): temporal collection over a
    static mesh round-trips points/cells/fields; layout carries the v2.0
    Version/Type attrs ParaView's reader checks."""
    import h5py

    from cardiac_ablation_ecm2.io.vtkhdf import (VTKHDFDataCollection,
                                                     read_vtkhdf)
    from cardiac_ablation_ecm2.mesh import make_cartesian_2d

    mesh = make_cartesian_2d(3, 2)
    path = str(tmp_path / "col.vtkhdf")
    rng = np.random.default_rng(0)
    fields = [rng.standard_normal(mesh.nv) for _ in range(3)]
    cells = [rng.standard_normal(mesh.ne) for _ in range(3)]
    with VTKHDFDataCollection(path, mesh) as col:
        for k in range(3):
            col.save(0.5 * k, {"T": fields[k]}, {"attr": cells[k]})

    with h5py.File(path, "r") as f:
        g = f["VTKHDF"]
        assert list(g.attrs["Version"]) == [2, 0]
        assert g.attrs["Type"] in (b"UnstructuredGrid", "UnstructuredGrid")
        assert int(g["Steps"].attrs["NSteps"]) == 3

    pts, conn, offs, types, steps = read_vtkhdf(path)
    assert pts.shape == (mesh.nv, 3)
    assert np.array_equal(conn.reshape(mesh.ne, 4), mesh.elements)
    assert np.all(types == 9)
    assert len(steps) == 3
    for k, (t, pd, cd) in enumerate(steps):
        assert t == 0.5 * k
        assert np.allclose(pd["T"], fields[k])
        assert np.allclose(cd["attr"], cells[k])


def test_vtkhdf_mixed_mesh(tmp_path):
    """Mixed tri+quad meshes write per-cell offsets/types."""
    from cardiac_ablation_ecm2.io.gmsh import read_gmsh
    from cardiac_ablation_ecm2.io.vtkhdf import (VTKHDFDataCollection,
                                                     read_vtkhdf)

    mesh, _ = read_gmsh(f"{DATA}/compass.msh")
    path = str(tmp_path / "mixed.vtkhdf")
    with VTKHDFDataCollection(path, mesh) as col:
        col.save(0.0, {"u": np.arange(mesh.nv, dtype=float)})
    pts, conn, offs, types, steps = read_vtkhdf(path)
    assert len(types) == mesh.ne
    assert set(types) == {5, 9}
    assert offs[-1] == conn.size
    assert np.allclose(steps[0][1]["u"], np.arange(mesh.nv))
