"""Rigid-foundation contact: elasticity + PDAS bound constraints
(ex28-class; rigid-obstacle normal contact, frictionless)."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg.obstacle import obstacle_solve
from cardiac_ablation_ecm2.mesh import Mesh, make_cartesian_2d
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.ops.linearform import boundary_lf_vector


def test_beam_on_rigid_floor():
    """Cantilever pressed down by a tip load onto a rigid floor at
    y = −gap: the deflection is capped exactly at the gap, contact
    pressure is nonnegative, and lift-off dofs are stationary."""
    m0 = make_cartesian_2d(16, 4)
    V = m0.vertices.copy()
    V[:, 0] *= 4.0
    V[:, 1] *= 0.5
    mesh = Mesh(geom=m0.geom, vertices=V, elements=m0.elements,
                attributes=m0.attributes, boundary=m0.boundary,
                bdr_attributes=m0.bdr_attributes)
    fes = FESpace(mesh, 1, vdim=2)
    ns = fes.ndof_scalar
    A = BilinearForm(fes).add_domain_integrator(
        "elasticity", coeff=(1.0, 1.0)).assemble()
    b = boundary_lf_vector(fes, np.array([0.0, -0.5]), bdr_marker=[2])

    # clamp x=0 (attr 4), both components
    ess_s = fes.essential_dofs([4])
    fm = jnp.zeros(fes.ndof).at[
        jnp.asarray(np.concatenate([ess_s, ess_s + ns]))].set(1.0)

    gap = 0.03
    # obstacle: u_y >= -gap on bottom-face dofs; -inf elsewhere
    bot = fes.essential_dofs([1])
    psi = np.full(fes.ndof, -1e30)
    psi[bot + ns] = -gap
    psi = jnp.asarray(psi)

    u, lam, outer = obstacle_solve(
        A.mult, b * (1 - fm), psi, diag=A.diagonal(), fixed_mask=fm)
    uy = np.asarray(u[ns:])
    assert outer < 40
    # bottom-surface deflection capped at the gap (interior dofs may move
    # further — the beam tilts about the contact zone)
    assert uy[bot].min() >= -gap - 1e-10
    contact = np.asarray(lam) > 1e-12
    assert contact.any(), "tip load should reach the floor"
    # contact happens at bottom dofs near the tip, at exactly -gap
    cdofs = np.nonzero(contact)[0]
    assert np.allclose(np.asarray(u)[cdofs], -gap, atol=1e-10)
    # without the floor the tip would dip below the gap
    from cardiac_ablation_ecm2.linalg.solvers import cg

    m = 1 - fm
    Ac = lambda v: A.mult(v * m) * m + v * (1 - m)
    u_free, _ = cg(Ac, b * m, M=lambda r: r / (A.diagonal() * m + (1 - m)),
                   rel_tol=1e-11, max_iter=4000)
    assert float(u_free[ns:].min()) < -gap
