"""Serial parity vs the actual MFEM reference binary (BASELINE.md metric).

Golden values below were produced by an MFEM 4.9.1-dev (this repo's
reference, built Release) driver solving −Δu = 1, u = 0 on ∂Ω with PA
assembly and CG+Jacobi rel_tol 1e-12, printing ∫u and ‖u‖_L2
(driver: /tmp/mfem-bench/parity.cpp pattern; values recorded 2026-08-16).

On meshes with affine elements (inline-quad, beam-hex) both codes integrate
the polynomial integrands exactly, so the discrete systems are *identical*
and functionals must match to solver tolerance (<1e-10 rel).  star.mesh has
non-affine bilinear quads where the two codes' default quadrature rules
differ, so agreement is to discretization-consistency (<2e-5 rel).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.gridfunction import l2_norm
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
from cardiac_ablation_ecm2.models import poisson

# (mesh, order) -> (ndof, mfem_integral, mfem_l2)
GOLDEN = {
    ("inline-quad.mesh", 1): (25, 0.03197544642857143, 0.0389216209596286),
    ("inline-quad.mesh", 2): (81, 0.03511831825680937, 0.04128207907681895),
    ("inline-quad.mesh", 3): (169, 0.03514340319264939, 0.04126174595099996),
    ("beam-hex.mesh", 2): (153, 0.2608727605714548, 0.1127344648409426),
    ("beam-hex.mesh", 3): (400, 0.2621110037823084, 0.1128173132086508),
    ("star.mesh", 1): (31, 0.6364623001371319, 0.361787436409353),
    ("star.mesh", 2): (101, 0.6878775778333308, 0.378912934784046),
    ("star.mesh", 3): (211, 0.6894191569483981, 0.379405195599703),
}

AFFINE = {"inline-quad.mesh", "beam-hex.mesh"}


@pytest.mark.parametrize("mesh_name,order", sorted(GOLDEN, key=str))
def test_poisson_functionals_match_mfem(mesh_name, order):
    ndof_ref, integral_ref, l2_ref = GOLDEN[(mesh_name, order)]
    mesh = read_mfem_mesh(f"/root/reference/data/{mesh_name}")
    res = poisson.solve(mesh, order=order, rhs=1.0, rel_tol=1e-12,
                        max_iter=4000)
    assert res.converged
    assert res.fes.ndof_scalar == ndof_ref    # identical dof counts
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    b = domain_lf(res.fes, None)
    integral = float(jnp.vdot(b, res.u))
    l2 = float(l2_norm(res.fes, res.u))
    tol = 1e-10 if mesh_name in AFFINE else 2e-5
    assert np.isclose(integral, integral_ref, rtol=tol), (
        integral, integral_ref
    )
    assert np.isclose(l2, l2_ref, rtol=tol), (l2, l2_ref)
