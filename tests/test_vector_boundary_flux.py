"""VectorBoundaryFluxLFIntegrator analog: b·x_v = ∮ f (v·n).

With v = x (the identity field, exactly representable at p ≥ 1),
∮ v·n = ∫ div v = sdim·|Ω| by the divergence theorem — a closed form that
pins quadrature, normal orientation, and byNODES component ordering at
machine precision (reference fem/lininteg.hpp:443).
"""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops.linearform import vector_boundary_flux_lf


def identity_coefs(fes):
    c = fes.dof_coords
    return jnp.asarray(np.concatenate([c[:, d] for d in range(c.shape[1])]))


def test_divergence_theorem_2d():
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 2)
    b = vector_boundary_flux_lf(fes, 1.0, vdim=2)
    got = float(jnp.dot(b, identity_coefs(fes)))
    assert abs(got - 2.0) < 1e-12


def test_divergence_theorem_3d():
    mesh = make_cartesian_3d(2, 2, 2)
    fes = FESpace(mesh, 2)
    b = vector_boundary_flux_lf(fes, 1.0, vdim=3)
    got = float(jnp.dot(b, identity_coefs(fes)))
    assert abs(got - 3.0) < 1e-12


def test_marked_face_only():
    # right face of the unit square (attribute 2 in make_cartesian_2d):
    # there v·n = x = 1 over a unit-length edge → ∮ = 1
    mesh = make_cartesian_2d(4, 4)
    fes = FESpace(mesh, 2)
    attrs = sorted(set(mesh.bdr_attributes.tolist()))
    vals = {}
    for a in attrs:
        b = vector_boundary_flux_lf(fes, 1.0, bdr_marker=[a], vdim=2)
        vals[a] = float(jnp.dot(b, identity_coefs(fes)))
    # each face contributes ∮ x·n: 0 for x=0 and y=0 faces, 1 for x=1 and y=1
    s = sorted(vals.values())
    assert np.allclose(s, [0.0, 0.0, 1.0, 1.0], atol=1e-12)
    assert abs(sum(vals.values()) - 2.0) < 1e-12
