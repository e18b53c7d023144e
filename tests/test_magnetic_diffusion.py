"""Transient magnetic diffusion on H(curl) (joule/maxwell transient EM)."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem.fespace import FESpace
from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.linalg.maxwell_eigen import maxwell_eigenvalues
from cardiac_ablation_ecm2.mesh.mesh import make_cartesian_2d
from cardiac_ablation_ecm2.models.magnetic_diffusion import (
    MagneticDiffusionOperator,
)


def test_cavity_mode_decay_rate():
    """Starting in the lowest PEC cavity eigenmode, σ∂A/∂t = −curl(ν curl
    A) decays exactly like e^{−λ₁ t} — validates the implicit stepping,
    the ND operators, and the eigensolver against each other."""
    mesh = make_cartesian_2d(4, 4)
    nd = NDSpaceHO(mesh, 2)
    h1 = FESpace(mesh, 2)
    res = maxwell_eigenvalues(nd, h1, k=1, iters=80)
    lam = float(res.eigenvalues[0])
    op = MagneticDiffusionOperator(
        nd, sigma=1.0, nu=1.0,
        ess_bdr=sorted(set(mesh.bdr_attributes.tolist())))
    x0 = res.eigenvectors[:, 0] * op.mask
    import jax

    solver = ode.select("sdirk33")
    step = jax.jit(lambda A, t, dt: solver.step(op, A, t, dt))
    A, t = x0, jnp.asarray(0.0)
    dt = jnp.asarray(0.01)
    for _ in range(20):
        A, t = step(A, t, dt)
    ratio = float(jnp.vdot(A, x0) / jnp.vdot(x0, x0))
    assert abs(ratio - np.exp(-lam * 0.2)) < 2e-4


def test_source_driven_steady_state():
    """With a steady source the field relaxes to the static solve
    CC A = J_s (on the PEC-constrained subspace)."""
    from cardiac_ablation_ecm2.linalg.solvers import cg

    mesh = make_cartesian_2d(4, 4)
    nd = NDSpaceHO(mesh, 1)

    def J(x):
        out = np.zeros(x.shape)
        out[..., 0] = np.sin(np.pi * x[..., 1])
        return out

    op = MagneticDiffusionOperator(
        nd, sigma=1.0, nu=1.0, source=J,
        ess_bdr=sorted(set(mesh.bdr_attributes.tolist())))
    import jax

    solver = ode.select("sdirk33")
    step = jax.jit(lambda A, t, dt: solver.step(op, A, t, dt))
    A, t = jnp.zeros(op.M.ndof), jnp.asarray(0.0)
    dt = jnp.asarray(0.5)
    for _ in range(40):
        A, t = step(A, t, dt)
    # steady state: residual b - CC A vanishes on the free dofs
    r = np.asarray(op.residual(A))
    scale = float(jnp.abs(op.b).max())
    assert np.abs(r).max() < 1e-6 * max(scale, 1.0)
