"""Anisotropic NC hex refinement (reference ref_type X/Y/Z bitmask,
mesh/ncmesh.hpp:662): typed splits, half-face constraints, typed 2:1
balance, forced refinement on crossing splits, and a boundary-layer AMR
use case."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.build import (basis_for, geom_factors_for,
                                                 restriction_for)
from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
from cardiac_ablation_ecm2.fem.quadinterp import eval_values
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.mesh.ncmesh import (ISO3, X3, Y3, Z3, make_nc,
                                                   refine_hexes_aniso)
from cardiac_ablation_ecm2.ops import BilinearForm


def test_x_split_conforming():
    """X-split of one hex of a 2×1×1 bar: the shared face is x-normal and
    stays unsplit — fully conforming."""
    nc = make_nc(make_cartesian_3d(2, 1, 1))
    nc2, parent = refine_hexes_aniso(nc, np.array([X3, 0]))
    assert nc2.mesh.ne == 3
    assert nc2.n_hanging == 0
    assert sorted(parent.tolist()) == [0, 0, 1]


def test_z_split_half_face():
    """Z-split of one hex of a 2×1×1 bar splits the shared face in z:
    2 edge hangers + 1 half-face (medial edge) constraint."""
    nc = make_nc(make_cartesian_3d(2, 1, 1))
    nc2, _ = refine_hexes_aniso(nc, np.array([Z3, 0]))
    assert nc2.mesh.ne == 3
    assert len(nc2.face_constraints) == 0
    assert len(nc2.half_face_constraints) == 1
    assert len(nc2.constraints) == 2          # shared vertical edge midpoints
    (mE, mF, A, B, C, D) = nc2.half_face_constraints[0]
    verts = nc2.mesh.vertices
    np.testing.assert_allclose(verts[mE], 0.5 * (verts[A] + verts[B]))
    np.testing.assert_allclose(verts[mF], 0.5 * (verts[C] + verts[D]))


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("ty", [X3, Y3, Z3, X3 | Y3])
def test_aniso_projection_exact(p, ty):
    """Degree-p polynomial through anisotropic hanging faces: prolongation
    reproduces it exactly at all quadrature points."""
    nc = make_nc(make_cartesian_3d(2, 2, 2))
    types = np.zeros(nc.mesh.ne, dtype=np.int64)
    types[0] = ty
    nc2, _ = refine_hexes_aniso(nc, types)
    sp = NCFESpace(nc2, p)

    def f(x):
        x = np.asarray(x)
        out = x[..., 0] ** p + 0.3 * x[..., 1] - 0.7 * x[..., 2]
        if p >= 2:
            out = out + x[..., 0] * x[..., 1] ** (p - 1) + x[..., 1] * x[..., 2]
        return out

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_crossing_splits_forced():
    """Neighbors splitting the shared face in CROSSING directions must be
    forced compatible (the CheckAnisoFace role): the result is a valid
    conforming-through-constraints space (polynomial exactness)."""
    nc = make_nc(make_cartesian_3d(2, 1, 1))
    # shared face is x-normal (spans y,z): e0 splits it in y, e1 in z
    nc2, _ = refine_hexes_aniso(nc, np.array([Y3, Z3]))
    # forced union: both elements end up split y AND z on that face
    assert nc2.mesh.ne >= 8
    sp = NCFESpace(nc2, 2)

    def f(x):
        x = np.asarray(x)
        return x[..., 0] * x[..., 1] + x[..., 2] ** 2 + 0.5 * x[..., 0]

    uc = jnp.asarray(f(sp.dof_coords))
    uL = sp.prolongate(uc)
    fes = sp.fes
    uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
    gf = geom_factors_for(fes)
    assert np.allclose(np.asarray(uq), f(np.asarray(gf.x)), atol=1e-10)


def test_ptap_vs_scipy():
    """PᵀAP through anisotropic constraints == explicit scipy product."""
    import scipy.sparse as sp_

    nc = make_nc(make_cartesian_3d(2, 2, 1))
    types = np.zeros(nc.mesh.ne, dtype=np.int64)
    types[0] = Z3
    types[3] = X3 | Z3
    nc2, _ = refine_hexes_aniso(nc, types)
    assert nc2.n_hanging > 0
    p = 2
    spc = NCFESpace(nc2, p)
    A = BilinearForm(spc.fes).add_domain_integrator("diffusion")
    A_L = A.assemble()
    A_csr = A.assemble_matrix()

    # explicit P
    nL, nC = spc.fes.ndof_scalar, spc.ndof_conf
    P = sp_.lil_matrix((nL, nC))
    P[np.asarray(spc.L_of_conf), np.arange(nC)] = 1.0
    si = np.asarray(spc._slave_idx)
    sm = np.asarray(spc._slave_masters)
    sw = np.asarray(spc._slave_w)
    for i in range(len(si)):
        for j in range(sm.shape[1]):
            if sw[i, j] != 0.0:
                P[si[i], sm[i, j]] += sw[i, j]
    P = P.tocsr()
    Ac_ref = (P.T @ A_csr @ P).toarray()

    rng = np.random.default_rng(0)
    X = rng.standard_normal((nC, 5))
    got = np.stack([
        np.asarray(spc.restrict_t(A_L.mult(spc.prolongate(jnp.asarray(x)))))
        for x in X.T
    ], axis=1)
    assert np.allclose(got, Ac_ref @ X, atol=1e-10)


def test_boundary_layer_amr():
    """Boundary-layer AMR: repeated Z-only refinement near z=0 resolves
    u = x(1−x) + e^{−z/ε}-style layers with far fewer dofs than iso.
    Solve −Δu = f with the manufactured layer solution and check the NC
    solve converges to it.  The solution is a pure z-layer so the error is
    controlled entirely by z-resolution — the regime aniso refinement is
    for (an x-varying factor would floor the error at the fixed coarse
    in-plane resolution and mask the layer gains)."""
    eps = 0.15

    def u_ex(x):
        x = np.asarray(x)
        return np.exp(-x[..., 2] / eps)

    def rhs(x):
        return -u_ex(x) / eps**2

    nc = make_nc(make_cartesian_3d(4, 4, 4))
    ndofs, errs = [], []
    for layers in (0, 1, 2):
        nc_r = nc
        for r in range(layers):
            # graded marking: interpolation-error indicator h_z^3·e^{-z/ε};
            # refining in z only where the layer is under-resolved
            v = nc_r.mesh.vertices[nc_r.mesh.elements][..., 2]
            zmin = v.min(axis=1)
            hz = v.max(axis=1) - zmin
            ind = hz**3 * np.exp(-zmin / eps)
            types = np.where(ind > 0.2 * ind.max(), Z3, 0)
            nc_r, _ = refine_hexes_aniso(nc_r, types)
        p = 2
        spc = NCFESpace(nc_r, p)
        A_L = BilinearForm(spc.fes).add_domain_integrator(
            "diffusion").assemble()
        Ac = spc.constrained_operator(A_L.mult)

        from cardiac_ablation_ecm2.ops.linearform import domain_lf

        b = spc.restrict_t(domain_lf(spc.fes, rhs))
        ess = spc.essential_dofs(None)
        mask = np.zeros(spc.ndof_conf)
        mask[ess] = 1.0
        mask = jnp.asarray(mask)
        xb = jnp.asarray(u_ex(spc.dof_coords)) * mask

        def Abc(v):
            z = v * (1 - mask)
            return Ac(z) * (1 - mask) + v * mask

        B = (b - Ac(xb)) * (1 - mask) + xb
        x, info = cg(Abc, B, M=lambda r: r, rel_tol=1e-10, max_iter=3000)
        assert bool(info.converged)
        uL = spc.prolongate(x)
        fes = spc.fes
        uq = eval_values(basis_for(fes), restriction_for(fes).mult(uL))
        gf = geom_factors_for(fes)
        err = np.sqrt(np.sum(np.asarray(gf.wdet)
                             * (np.asarray(uq) - u_ex(np.asarray(gf.x)))**2))
        ndofs.append(spc.ndof_conf)
        errs.append(err)
    # each layer round roughly halves the layer error at modest dof growth
    assert errs[1] < 0.55 * errs[0], errs
    assert errs[2] < 0.55 * errs[1], errs
    assert ndofs[2] < 2.5 * ndofs[0], ndofs
