"""Device LOR: batched on-device assembly + geometric MG on the LOR lattice
(the all-device BoomerAMG seat; reference fem/lor/lor_batched.hpp:34 +
fem/lor/lor.hpp:201)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.lor import lor_matrix
from cardiac_ablation_ecm2.ops.lor_device import (
    DeviceLOROperator, lor_element_matrices, make_lor_multigrid)
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def _dense_from_device(fes, **kw):
    A_e, conn = lor_element_matrices(fes, **kw)
    n = fes.ndof_scalar
    A = np.zeros((n, n))
    Ae = np.asarray(A_e)
    for s in range(conn.shape[0]):
        ix = conn[s]
        A[np.ix_(ix, ix)] += Ae[s]
    return A


def test_device_matches_host_assembly():
    """Batched device LOR matrices == host scipy lor_matrix (same Q1 rule)."""
    for mesh, p in [(make_cartesian_2d(3, 2), 3),
                    (make_cartesian_3d(2, 2, 2), 2)]:
        fes = FESpace(mesh, p)
        Ah = lor_matrix(fes, 1.0, mass_coeff=0.7).toarray()
        Ad = _dense_from_device(fes, diffusion_coeff=1.0, mass_coeff=0.7)
        assert np.abs(Ah - Ad).max() < 1e-10 * max(1.0, np.abs(Ah).max())


def test_device_operator_apply():
    """DeviceLOROperator.mult == dense LOR matvec; diagonal matches."""
    mesh = make_cartesian_3d(2, 2, 2)
    fes = FESpace(mesh, 3)
    op = DeviceLOROperator(fes, 1.0, mass_coeff=None, ess=None)
    A = _dense_from_device(fes, diffusion_coeff=1.0)
    x = np.sin(np.arange(fes.ndof_scalar, dtype=np.float64))
    assert np.abs(np.asarray(op.mult(jnp.asarray(x))) - A @ x).max() < 1e-10
    assert np.abs(np.asarray(op.diagonal()) - np.diag(A)).max() < 1e-10


def _poisson_iters(n, p, M=None):
    mesh = make_cartesian_3d(n, n, n)
    fes = FESpace(mesh, p)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = fes.essential_dofs(None)
    mask = jnp.zeros(fes.ndof_scalar).at[jnp.asarray(ess)].set(1.0)

    def Aop(x):
        z = x * (1 - mask)
        return A.mult(z) * (1 - mask) + x * mask

    b = domain_lf(fes, lambda x: np.sin(3 * x[..., 0]) + x[..., 1])
    b = b * (1 - mask)
    if M is None:
        dg = A.diagonal() * (1 - mask) + mask
        M = lambda r: r / dg  # noqa: E731
    else:
        Minner = M
        M = lambda r: Minner(r * (1 - mask)) * (1 - mask) + r * mask  # noqa: E731
    x, info = cg(Aop, b, M=M, rel_tol=1e-10, max_iter=3000)
    r = b - Aop(x)
    assert float(jnp.linalg.norm(r)) < 1e-8 * max(1.0, float(jnp.linalg.norm(b)))
    return int(info.iterations)


def test_lor_mg_bounded_iterations_under_refinement():
    """LOR-MG PCG iteration counts stay ~flat in h where Jacobi grows."""
    jac, lor = [], []
    for n in (2, 4, 8):
        jac.append(_poisson_iters(n, 3))
        mesh = make_cartesian_3d(n, n, n)
        fes = FESpace(mesh, 3)
        mg = make_lor_multigrid(fes, 1.0, ess_bdr=None)
        lor.append(_poisson_iters(n, 3, M=mg.preconditioner()))
    # Jacobi roughly doubles per refinement; LOR-MG stays bounded
    assert jac[-1] / jac[0] > 2.0, jac
    assert lor[-1] <= lor[0] + 6, (jac, lor)
    assert lor[-1] < jac[-1] / 2, (jac, lor)


def test_lor_mg_order_robust():
    """Iterations grow slowly with p (spectral equivalence of LOR)."""
    its = []
    for p in (2, 4):
        mesh = make_cartesian_3d(3, 3, 3)
        fes = FESpace(mesh, p)
        mg = make_lor_multigrid(fes, 1.0, ess_bdr=None)
        its.append(_poisson_iters(3, p, M=mg.preconditioner()))
    assert its[1] <= 3 * max(its[0], 1) + 10, its
