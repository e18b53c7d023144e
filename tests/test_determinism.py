"""Determinism: repeated operator applies and scatters must be bitwise
identical (reference analog: tests/unit/fem/test_fa_determinism.cpp; our
scatter is a sorted segment-sum, so determinism is structural — this guards
against regressions to nondeterministic accumulation)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import basis_for, geom_factors_for, restriction_for
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.ops import BilinearForm
from test_fespace import permute_vertices, perturb


def test_apply_bitwise_deterministic():
    mesh = perturb(permute_vertices(make_cartesian_3d(3, 3, 3), 4), 0.1)
    fes = FESpace(mesh, 3)
    A = (
        BilinearForm(fes)
        .add_domain_integrator("diffusion")
        .add_domain_integrator("mass", 2.0)
        .assemble()
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(fes.ndof_scalar))
    y1 = np.asarray(A.mult(x))
    for _ in range(3):
        y2 = np.asarray(A.mult(x))
        assert np.array_equal(y1, y2)     # bitwise


def test_scatter_bitwise_deterministic():
    mesh = make_cartesian_3d(3, 3, 3)
    fes = FESpace(mesh, 2)
    R = restriction_for(fes)
    rng = np.random.default_rng(1)
    E = jnp.asarray(rng.random((mesh.ne, fes.nd_elem)))
    y1 = np.asarray(R.mult_transpose(E))
    for _ in range(3):
        assert np.array_equal(y1, np.asarray(R.mult_transpose(E)))
