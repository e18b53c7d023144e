"""Mixed tri+quad meshes: conforming dof numbering across geometry blocks,
projection exactness (incl. p=3 — GLL-warped simplex edge nodes), and
Poisson convergence through the tri/quad interface."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.mixed import (
    MixedFESpace,
    MixedPAOperator,
    make_mixed_strip,
    mixed_domain_lf,
)
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg


@pytest.mark.parametrize("p", [1, 2, 3])
def test_projection_continuous_and_exact(p):
    """Nodal projection of a degree-p polynomial evaluates exactly at every
    block's quadrature points — requires the tri and quad blocks to SHARE
    interface dofs (conformity) and both bases to reproduce the polynomial."""
    mesh = make_mixed_strip(3)
    fes = MixedFESpace(mesh, p)

    def f(x):
        x = np.asarray(x)
        out = x[..., 0] ** p + 0.3 * x[..., 1]
        if p >= 2:
            out = out + x[..., 0] * x[..., 1] ** (p - 1)
        return out

    u = fes.project(f)
    for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
        uq = eval_values(db, R.mult(u))
        assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_interface_dofs_shared():
    mesh = make_mixed_strip(2)
    fes = MixedFESpace(mesh, 2)
    # total dofs must be fewer than the broken sum (interface shared)
    broken = sum(gm.size for gm in fes.gather_maps)
    assert fes.ndof_scalar < broken
    # dof ids on the x=0.5 line appear in BOTH blocks' gather maps
    X = fes.dof_coords
    on_if = np.nonzero(np.isclose(X[:, 0], 0.5))[0]
    assert len(on_if) > 0
    in_q = np.isin(on_if, fes.gather_maps[0].reshape(-1))
    in_t = np.isin(on_if, fes.gather_maps[1].reshape(-1))
    assert in_q.all() and in_t.all()


def _solve(n, p):
    mesh = make_mixed_strip(n)
    fes = MixedFESpace(mesh, p)
    op = MixedPAOperator(fes, diffusion_coeff=1.0)

    def u_ex(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    b = mixed_domain_lf(fes, lambda x: 2 * np.pi**2 * u_ex(x))
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = op.diagonal()
    x, info = cg(Aop, b * (1 - mask),
                 M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                 rel_tol=1e-11, max_iter=4000)
    # L2 error summed over blocks
    err2 = 0.0
    for db, gf, R in zip(fes.dbs, fes.gfs, fes.restrictions):
        uq = np.asarray(eval_values(db, R.mult(x)))
        ex = u_ex(np.asarray(gf.x))
        err2 += float(np.sum(np.asarray(gf.wdet) * (uq - ex) ** 2))
    return np.sqrt(err2)


@pytest.mark.parametrize("p,min_rate", [(1, 1.8), (2, 2.8), (3, 3.6)])
def test_poisson_converges(p, min_rate):
    e1 = _solve(2, p)
    e2 = _solve(4, p)
    rate = np.log2(e1 / e2)
    assert rate > min_rate, (p, e1, e2, rate)


def test_gmsh_compass_mixed():
    """The reference's compass.msh (mixed tri+quad, physical names) loads as
    a MixedMesh and a Poisson solve on it converges."""
    import os

    path = "/root/reference/data/compass.msh"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    from cardiac_ablation_ecm2.io.gmsh import read_gmsh
    from cardiac_ablation_ecm2.fem.mixed import MixedMesh

    mesh, names = read_gmsh(path)
    assert isinstance(mesh, MixedMesh)
    assert len(mesh.blocks) == 2
    fes = MixedFESpace(mesh, 2)
    op = MixedPAOperator(fes, diffusion_coeff=1.0)
    b = mixed_domain_lf(fes, lambda x: np.ones(x.shape[:-1]))
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    x, info = cg(Aop, b * (1 - mask), rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged)
    assert float(jnp.abs(x).max()) > 0


def test_mfem_v10_mixed_mesh():
    """square-mixed.mesh (MFEM v1.0 mixed tri+quad with order-1 nodes
    GridFunction) loads as MixedMesh; Poisson solves; area exact."""
    import os

    path = "/root/reference/data/square-mixed.mesh"
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    from cardiac_ablation_ecm2.fem.mixed import MixedMesh
    from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh

    mesh = read_mfem_mesh(path)
    assert isinstance(mesh, MixedMesh)
    fes = MixedFESpace(mesh, 2)
    area = sum(float(np.asarray(gf.wdet).sum()) for gf in fes.gfs)
    assert np.isclose(area, 1.0, atol=1e-12)
    op = MixedPAOperator(fes, diffusion_coeff=1.0)
    b = mixed_domain_lf(fes, lambda x: np.ones(x.shape[:-1]))
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    x, info = cg(Aop, b * (1 - mask), rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged)


def test_mixed_roundtrip_and_vtu(tmp_path):
    """MixedMesh → MFEM v1.0 text → read back; VTU export smoke."""
    from cardiac_ablation_ecm2.fem.mixed import MixedMesh
    from cardiac_ablation_ecm2.io.mesh_io import (
        read_mfem_mesh,
        write_mfem_mesh,
    )
    from cardiac_ablation_ecm2.io.vtu import write_vtu_mixed

    mesh = make_mixed_strip(2)
    text = write_mfem_mesh(mesh)
    m2 = read_mfem_mesh(text)
    assert isinstance(m2, MixedMesh)
    assert m2.ne == mesh.ne and m2.nbe == mesh.nbe
    assert np.allclose(m2.vertices, mesh.vertices)
    fes1 = MixedFESpace(mesh, 2)
    fes2 = MixedFESpace(m2, 2)
    assert fes1.ndof_scalar == fes2.ndof_scalar

    fn = str(tmp_path / "mixed.vtu")
    write_vtu_mixed(mesh, fn, point_data={"z": np.zeros(mesh.nv)})
    txt = open(fn).read()
    assert txt.count("<Piece") == 1 and "types" in txt
