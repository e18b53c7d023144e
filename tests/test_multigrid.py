"""p- and h-multigrid preconditioning (ex26 analog): V-cycle-PCG must beat
Jacobi-PCG decisively in iteration count and reach the same solution."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.transfer import HTransfer, PTransfer
from cardiac_ablation_ecm2.linalg.multigrid import make_h_multigrid, make_p_multigrid
from cardiac_ablation_ecm2.linalg.smoothers import jacobi
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm, ConstrainedOperator
from cardiac_ablation_ecm2.ops.linearform import domain_lf


def test_p_transfer_exactness():
    """Prolongation of a coarse-space function is exact interpolation."""
    mesh = make_cartesian_2d(4, 4)
    fc, ff = FESpace(mesh, 2), FESpace(mesh, 4)
    tr = PTransfer(fc, ff)
    from cardiac_ablation_ecm2.fem.gridfunction import project

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 + 0.5 * x[..., 0] * x[..., 1]

    uc = project(fc, f)
    uf = tr.prolongate(uc)
    uf_direct = project(ff, f)
    assert np.allclose(np.asarray(uf), np.asarray(uf_direct), atol=1e-12)
    # adjointness
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.random(fc.ndof_scalar))
    b = jnp.asarray(rng.random(ff.ndof_scalar))
    assert np.isclose(
        float(jnp.vdot(tr.prolongate(a), b)),
        float(jnp.vdot(a, tr.restrict_t(b))),
        rtol=1e-12,
    )


def test_h_transfer_exactness():
    mesh_c = make_cartesian_2d(3, 3)
    mesh_f = mesh_c.uniform_refinement()
    fc, ff = FESpace(mesh_c, 2), FESpace(mesh_f, 2)
    tr = HTransfer(fc, ff)
    from cardiac_ablation_ecm2.fem.gridfunction import project

    def f(x):
        x = np.asarray(x)
        return x[..., 0] ** 2 - x[..., 1] + 0.3 * x[..., 0] * x[..., 1]

    uf = tr.prolongate(project(fc, f))
    assert np.allclose(np.asarray(uf), np.asarray(project(ff, f)), atol=1e-12)
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.random(fc.ndof_scalar))
    b = jnp.asarray(rng.random(ff.ndof_scalar))
    assert np.isclose(
        float(jnp.vdot(tr.prolongate(a), b)),
        float(jnp.vdot(a, tr.restrict_t(b))),
        rtol=1e-12,
    )


def _constrained_diffusion(fes):
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = fes.essential_dofs()
    return ConstrainedOperator.wrap(A.operator(), ess)


@pytest.mark.parametrize("builder", ["p", "h"])
def test_multigrid_pcg_beats_jacobi(builder):
    mesh = make_cartesian_2d(16, 16)
    if builder == "p":
        order = 4
        fes = FESpace(mesh, order)
        mg = make_p_multigrid(
            lambda p: fes if p == order else FESpace(mesh, p),
            _constrained_diffusion,
            orders=(1, 2, 4),
            ess_factory=lambda f: f.essential_dofs(),
        )
    else:
        order = 2
        meshes = [make_cartesian_2d(4, 4)]
        for _ in range(2):
            meshes.append(meshes[-1].uniform_refinement())
        mesh = meshes[-1]
        fes = FESpace(mesh, order)
        mg = make_h_multigrid(
            meshes,
            lambda m: fes if m is mesh else FESpace(m, order),
            _constrained_diffusion,
            ess_factory=lambda f: f.essential_dofs(),
        )

    A = _constrained_diffusion(fes)
    b = domain_lf(fes, None)
    b = jnp.asarray(np.asarray(b)).at[jnp.asarray(fes.essential_dofs())].set(0.0)

    x_j, info_j = cg(A.mult, b, M=jacobi(A.diagonal()), rel_tol=1e-10,
                     max_iter=2000)
    x_mg, info_mg = cg(A.mult, b, M=mg.preconditioner(), rel_tol=1e-10,
                       max_iter=200)
    assert bool(info_mg.converged)
    assert int(info_mg.iterations) < int(info_j.iterations) / 3, (
        int(info_mg.iterations), int(info_j.iterations)
    )
    assert np.allclose(np.asarray(x_mg), np.asarray(x_j), atol=1e-7)
