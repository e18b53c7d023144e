"""LOR preconditioning: spectral equivalence of the low-order-refined
operator (lor.hpp:69 analog) and PCG acceleration."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.lor import LORPreconditioner, lor_matrix
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def test_spectral_equivalence():
    """cond(A_LOR⁻¹ A_HO) on free dofs is small and p-independent-ish."""
    mesh = make_cartesian_3d(2, 2, 2)
    fes = FESpace(mesh, 3)
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar, bool)
    mask[ess] = True
    free = ~mask
    Aho = BilinearForm(fes).add_domain_integrator(
        "diffusion").assemble_matrix().toarray()
    Alor = lor_matrix(fes, 1.0).toarray()
    w = np.linalg.eigvalsh(
        np.linalg.solve(Alor[np.ix_(free, free)], Aho[np.ix_(free, free)])
    )
    assert w.min() > 0.3
    assert w.max() / w.min() < 20.0, (w.min(), w.max())


def test_lor_pcg_beats_jacobi():
    mesh = make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, 4)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    b = domain_lf(fes, lambda x: np.sin(3 * x[..., 0]) + x[..., 1])
    ess = fes.essential_dofs(None)
    mask = np.zeros(fes.ndof_scalar)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = A.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    bi = b * (1 - mask)
    dg = A.diagonal()
    x1, i1 = cg(Aop, bi, M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                rel_tol=1e-10, max_iter=3000)
    M = LORPreconditioner(fes, 1.0, ess=ess)
    x2, i2 = cg(Aop, bi, M=lambda r: M(r) * (1 - mask) + r * mask,
                rel_tol=1e-10, max_iter=3000)
    assert int(i2.iterations) < int(i1.iterations)
    assert float(jnp.abs(x1 - x2).max()) < 1e-8


def test_lor_2d_mass_diffusion():
    """Mass + diffusion LOR matrix is SPD and equivalent in 2D too."""
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 3)
    Aho = (BilinearForm(fes)
           .add_domain_integrator("diffusion")
           .add_domain_integrator("mass")
           .assemble_matrix().toarray())
    Alor = lor_matrix(fes, 1.0, mass_coeff=1.0).toarray()
    w = np.linalg.eigvalsh(np.linalg.solve(Alor, Aho))
    assert w.min() > 0.2 and w.max() / w.min() < 30.0, (w.min(), w.max())
