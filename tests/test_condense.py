"""Static condensation: condensed Poisson solve == full solve; interior
recovery exact; condensed system is smaller (staticcond.hpp:63 analog)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.condense import (
    StaticCondensation,
    element_matrices,
)
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def _poisson_full(fes, b, ess):
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A = a.assemble()
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = A.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    x, info = cg(Aop, b * (1 - mask), rel_tol=1e-12, max_iter=3000)
    return x, info


def _poisson_cond(fes, b, ess):
    Ae = element_matrices(fes, diffusion_coeff=1.0)
    sc = StaticCondensation(fes, Ae)
    br = sc.reduce_rhs(b)
    essc = sc.essential_dofs(None)
    mask = np.zeros(sc.n_iface)
    mask[essc] = 1.0
    mask = jnp.asarray(mask)

    def Sop(x):
        y = sc.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = sc.diagonal()
    xf, info = cg(Sop, br * (1 - mask), M=lambda r: r / jnp.where(
        mask > 0, 1.0, dg), rel_tol=1e-12, max_iter=3000)
    return sc.recover(xf, b), info, sc


def test_condensed_matches_full_3d():
    mesh = make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, 3)
    b = domain_lf(fes, lambda x: np.sin(x[..., 0]) + x[..., 1] * x[..., 2])
    ess = fes.essential_dofs(None)

    x_full, _ = _poisson_full(fes, b, ess)
    x_cond, info, sc = _poisson_cond(fes, b, ess)

    assert sc.n_iface < fes.ndof_scalar          # actually smaller
    ncell = (fes.order - 1) ** 3 * mesh.ne
    assert sc.n_iface == fes.ndof_scalar - ncell
    err = np.abs(np.asarray(x_full - x_cond)).max()
    scale = np.abs(np.asarray(x_full)).max()
    assert err < 1e-8 * scale, err


def test_condensed_matches_full_2d_mass_diffusion():
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 4)
    Ae = element_matrices(fes, diffusion_coeff=2.0, mass_coeff=0.7)
    sc = StaticCondensation(fes, Ae)

    # operator equivalence on random interface vectors: S x_f vs the Schur
    # action computed from the full element matrices
    import scipy.sparse as sps

    gm = fes.gather_map.astype(np.int64)
    nd = gm.shape[1]
    rows = np.repeat(gm, nd, axis=1).reshape(-1)
    cols = np.tile(gm, (1, nd)).reshape(-1)
    A = sps.coo_matrix(
        (np.asarray(Ae).reshape(-1), (rows, cols)),
        shape=(fes.ndof_scalar, fes.ndof_scalar),
    ).tocsr()
    ii = sc.iface_dofs
    cc = np.setdiff1d(np.arange(fes.ndof_scalar), ii)
    Aff = A[ii][:, ii].toarray()
    Afc = A[ii][:, cc].toarray()
    Acc = A[cc][:, cc].toarray()
    S_ref = Aff - Afc @ np.linalg.solve(Acc, Afc.T)

    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.random(sc.n_iface)
        y1 = np.asarray(sc.mult(jnp.asarray(x)))
        y2 = S_ref @ x
        assert np.abs(y1 - y2).max() < 1e-9 * np.abs(y2).max()
