"""Sharded H(curl)/H(div) solves vs serial (ex3p/ex4p analogs) on the
8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO, RTSpaceHO
from cardiac_ablation_ecm2.fem.fe_vector_simplex import (
    NDSimplexSpace,
    RTSimplexSpace,
)
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh.mesh import (
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)
from cardiac_ablation_ecm2.parallel import pvecfe
from tests.test_fespace import permute_vertices


def _f(x):
    x = np.asarray(x)
    dim = x.shape[-1]
    comps = [np.sin(x[..., 0]) + x[..., 1],
             np.cos(x[..., 1]) - 0.5 * x[..., 0]]
    if dim == 3:
        comps.append(x[..., 2] ** 2)
    return np.stack(comps, axis=-1)


def _serial(op, ess, rel_tol=1e-11):
    b = vecfe_linear_form(op, _f)
    d = op.diagonal()
    if len(ess):
        m = jnp.ones(op.ndof).at[jnp.asarray(ess)].set(0.0)
        b = b * m
        A = lambda v: op.mult(v * m) * m + v * (1 - m)
        d = d * m + (1 - m)
    else:
        A = op.mult
    x, info = cg(A, b, M=lambda r: r / d, rel_tol=rel_tol, max_iter=4000)
    assert bool(info.converged)
    return np.asarray(x), info.iterations


CASES = [
    ("nd-hex", False, lambda: (NDSpaceHO(permute_vertices(
        make_cartesian_3d(2, 2, 2), 3), 2),
        dict(mass_coeff=1.0, curlcurl_coeff=1.0))),
    ("rt-hex", False, lambda: (RTSpaceHO(permute_vertices(
        make_cartesian_3d(2, 2, 2), 5), 2),
        dict(mass_coeff=1.0, divdiv_coeff=0.7))),
    ("nd-tet-ess", True, lambda: (NDSimplexSpace(permute_vertices(
        make_cartesian_3d_tet(2, 2, 2), 1), 2),
        dict(mass_coeff=1.0, curlcurl_coeff=1.0))),
    ("rt-tri-ess", True, lambda: (RTSimplexSpace(permute_vertices(
        make_cartesian_2d_tri(3, 3), 7), 2),
        dict(mass_coeff=1.0, divdiv_coeff=1.0))),
]


@pytest.mark.parametrize("name,with_ess,make", CASES,
                         ids=[c[0] for c in CASES])
def test_parallel_matches_serial(name, with_ess, make):
    space, coeffs = make()
    nq1d = 4
    if with_ess:
        ess_bdr = sorted(set(space.mesh.bdr_attributes.tolist()))
        ess = space.essential_dofs(ess_bdr)
        assert len(ess) > 0
    else:
        ess_bdr = None
        ess = np.zeros(0, np.int32)

    build = (build_nd_operator if "nd" in name else build_rt_operator)
    op = build(space, nq1d=nq1d, **coeffs)
    x_ser, it_ser = _serial(op, ess)

    solver = pvecfe.setup(
        space, ndev=8, nq1d=nq1d, rhs_fn=_f, ess_bdr=ess_bdr,
        rel_tol=1e-11, max_iter=4000,
        devices=jax.devices("cpu"), **coeffs)
    x_par, it_par, final = solver.solve()

    err = np.abs(x_par - x_ser).max()
    scale = max(np.abs(x_ser).max(), 1.0)
    assert err < 1e-8 * scale, (err, scale)
    # same operator, same preconditioner class → comparable iterations
    assert abs(it_par - it_ser) <= max(3, int(0.1 * it_ser)), \
        (it_par, it_ser)
