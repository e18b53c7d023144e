"""Element restriction (fem/restriction.ElementRestriction) against a plain
numpy gather / scatter-add: L→E ``mult``, E→L ``mult_transpose`` and their
transposed-layout forms, on a quad, a hex, an order-2 tet space and a map
that leaves some dofs untouched (multiplicity 0 — they must read exactly 0).
Reference analog: ``ElementRestriction::Mult/MultTranspose``
(fem/restriction.cpp)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.restriction import ElementRestriction
from cardiac_ablation_ecm2.mesh import (make_cartesian_2d, make_cartesian_3d,
                                        make_cartesian_3d_tet)


def _gather_map(case):
    if case == "quad":
        fes = FESpace(make_cartesian_2d(5, 4), 3)
    elif case == "hex":
        fes = FESpace(make_cartesian_3d(3, 4, 2), 2)
    elif case == "tet_o2":
        fes = FESpace(make_cartesian_3d_tet(3, 2, 2), 2)
    else:
        # only even dofs used, multiplicity up to ~16
        rng = np.random.default_rng(5)
        return (2 * rng.integers(0, 100, size=(100, 16))), 200
    return np.asarray(fes.gather_map), fes.ndof_scalar


@pytest.mark.parametrize("case", ["quad", "hex", "tet_o2", "zero_mult"])
def test_restriction_matches_numpy(case):
    gm, ndof = _gather_map(case)
    r = ElementRestriction.from_map(gm, ndof)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(ndof)
    ue = rng.standard_normal(gm.shape)

    ref_e = u[gm]
    ref_l = np.zeros(ndof)
    np.add.at(ref_l, gm.reshape(-1), ue.reshape(-1))

    assert np.array_equal(np.asarray(r.mult(jnp.asarray(u))), ref_e)
    assert np.array_equal(np.asarray(r.mult_t(jnp.asarray(u))), ref_e.T)
    got = np.asarray(r.mult_transpose(jnp.asarray(ue)))
    np.testing.assert_allclose(got, ref_l, rtol=1e-13, atol=1e-13)
    gotT = np.asarray(r.mult_transpose_t(jnp.asarray(ue.T)))
    np.testing.assert_allclose(gotT, ref_l, rtol=1e-13, atol=1e-13)
    counts = np.bincount(gm.reshape(-1), minlength=ndof)
    assert np.array_equal(np.asarray(r.counts()), counts)
    # untouched dofs read exactly zero, not a neighbour's segment sum
    assert np.all(got[counts == 0] == 0.0)
