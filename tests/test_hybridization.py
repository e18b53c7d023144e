"""Hybridization (face-multiplier) H(div) solves vs conforming reference.

Reference analog: ``Hybridization`` (fem/hybridization.hpp:62) as used by
ex4 -hb (grad-div) — here validated by comparing the hybridized solution
against the conforming global solve of the identical operator.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fe_vector_simplex import RTSimplexSpace
from cardiac_ablation_ecm2.fem.fe_vector_ho import RTSpaceHO
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d_tet,
)
from tests.test_fespace import permute_vertices
from cardiac_ablation_ecm2.ops.hybridization import hybridize_hdiv
from cardiac_ablation_ecm2.ops.vecfe import (
    build_rt_operator,
    vecfe_linear_form,
)


def _f(x):
    return np.stack(
        [np.sin(x[..., 0]) + x[..., 1] ** 2]
        + [np.cos(x[..., i]) for i in range(1, x.shape[-1])],
        axis=-1,
    )


@pytest.mark.parametrize(
    "make",
    [
        lambda: (RTSimplexSpace(permute_vertices(
            make_cartesian_2d_tri(4, 4), 3), 2), 4),
        lambda: (RTSimplexSpace(permute_vertices(
            make_cartesian_3d_tet(2, 2, 2), 5), 1), 3),
        lambda: (RTSpaceHO(make_cartesian_2d(4, 4), 2), 4),
    ],
    ids=["tri-rt2", "tet-rt1", "quad-rt2"],
)
def test_hybridized_matches_conforming_natural(make):
    space, nq1d = make()
    op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=0.8,
                           nq1d=nq1d)
    b = vecfe_linear_form(op, _f)
    diag = op.diagonal()
    u_ref, info_ref = cg(op.mult, b, M=lambda r: r / diag,
                         rel_tol=1e-13, max_iter=4000)
    assert bool(info_ref.converged)

    hy = hybridize_hdiv(space, op)
    u_hy, lam, info = hy.solve(_f, rel_tol=1e-13)
    assert bool(info.converged)
    # interface system is strictly smaller than the global one
    assert 0 < hy.nlam < op.ndof
    err = np.abs(np.asarray(u_hy - u_ref)).max()
    ref = np.abs(np.asarray(u_ref)).max()
    assert err < 1e-8 * max(ref, 1.0), (err, ref)


def test_hybridized_essential_bc_tri():
    """Nonzero essential (normal-trace) BCs: hybridized solve matches dense
    elimination on the assembled conforming matrix."""
    mesh = permute_vertices(make_cartesian_2d_tri(3, 3), 7)
    space = RTSimplexSpace(mesh, 2)
    op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=0.5, nq1d=4)
    gm = np.asarray(op.gather)

    # boundary edge dofs: edge slots whose canonical dof appears once
    nedge_slots = space.nle * space.nE
    flat, counts = np.unique(gm.reshape(-1), return_counts=True)
    once = set(flat[counts == 1].tolist())
    ess = np.unique([d for d in gm[:, :nedge_slots].reshape(-1)
                     if d in once])
    assert len(ess) > 0

    rng = np.random.default_rng(0)
    bc = np.zeros(op.ndof)
    bc[ess] = rng.standard_normal(len(ess))

    b = np.asarray(vecfe_linear_form(op, _f))
    A = op.assemble_matrix().toarray()
    free = np.setdiff1d(np.arange(op.ndof), ess)
    x = bc.copy()
    x[free] = np.linalg.solve(
        A[np.ix_(free, free)], b[free] - A[np.ix_(free, ess)] @ bc[ess])

    hy = hybridize_hdiv(space, op, ess=ess, bc_vals=jnp.asarray(bc))
    u_hy, lam, info = hy.solve(_f, rel_tol=1e-13)
    assert bool(info.converged)
    err = np.abs(np.asarray(u_hy) - x).max()
    assert err < 1e-8 * max(np.abs(x).max(), 1.0), err


def test_multiplier_count_is_interior_faces():
    """One multiplier per interior-face canonical dof (RT1 on tets: 3 per
    interior face)."""
    mesh = make_cartesian_3d_tet(2, 2, 2)
    space = RTSimplexSpace(mesh, 1)
    op = build_rt_operator(space, mass_coeff=1.0, nq1d=3)
    gm = np.asarray(op.gather)
    _, counts = np.unique(gm.reshape(-1), return_counts=True)
    hy = hybridize_hdiv(space, op)
    assert hy.nlam == int((counts == 2).sum())
