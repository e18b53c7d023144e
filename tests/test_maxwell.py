"""Definite Maxwell (ex3) and H(div) div-div (ex4) analogs on higher-order
ND/RT spaces with essential tangential/normal BCs."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO, RTSpaceHO
from cardiac_ablation_ecm2.linalg.solvers import cg
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.ops.vecfe import (
    build_nd_operator,
    build_rt_operator,
    vecfe_linear_form,
)


def _solve_maxwell(n, order):
    """curl curl E + E = f, E×n = 0; exact E_i = sin(πx_j)sin(πx_k) (div-free,
    zero tangential trace) ⇒ f = (2π² + 1) E."""
    mesh = make_cartesian_3d(n, n, n)
    space = NDSpaceHO(mesh, order)
    op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                           nq1d=order + 2)

    def E(x):
        s = np.sin(np.pi * x)
        return np.stack([
            s[..., 1] * s[..., 2],
            s[..., 2] * s[..., 0],
            s[..., 0] * s[..., 1],
        ], axis=-1)

    b = vecfe_linear_form(op, lambda x: (2 * np.pi**2 + 1) * E(x))
    ess = space.essential_dofs(None)
    mask = np.zeros(space.ndof)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = op.diagonal()
    x, info = cg(Aop, b * (1 - mask),
                 M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                 rel_tol=1e-11, max_iter=4000)
    # L2 error at quadrature points
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    ex = E(np.asarray(op.gf.x))
    w = np.asarray(op.gf.wdet)
    err = np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2))
    return err, int(info.iterations)


def test_maxwell_converges():
    e1, _ = _solve_maxwell(2, 2)
    e2, _ = _solve_maxwell(4, 2)
    rate = np.log2(e1 / e2)
    assert rate > 1.6, (e1, e2, rate)
    assert e2 < 0.02


def _solve_divdiv(n, order):
    """div div σ... : (div σ, div τ) + (σ, τ) = (f, τ), σ·n = 0;
    exact σ = (sin πx cos πy cos πz, cos·sin·cos, cos·cos·sin) ⇒
    f = (1 + 3π²) σ."""
    mesh = make_cartesian_3d(n, n, n)
    space = RTSpaceHO(mesh, order)
    op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=1.0,
                           nq1d=order + 2)

    def sig(x):
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        return np.stack([
            s[..., 0] * c[..., 1] * c[..., 2],
            c[..., 0] * s[..., 1] * c[..., 2],
            c[..., 0] * c[..., 1] * s[..., 2],
        ], axis=-1)

    b = vecfe_linear_form(op, lambda x: (1 + 3 * np.pi**2) * sig(x))
    ess = space.essential_dofs(None)
    mask = np.zeros(space.ndof)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = op.diagonal()
    x, info = cg(Aop, b * (1 - mask),
                 M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                 rel_tol=1e-11, max_iter=4000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    ex = sig(np.asarray(op.gf.x))
    w = np.asarray(op.gf.wdet)
    return np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2))


def test_divdiv_converges():
    e1 = _solve_divdiv(2, 2)
    e2 = _solve_divdiv(4, 2)
    rate = np.log2(e1 / e2)
    assert rate > 1.6, (e1, e2, rate)
    assert e2 < 0.02


def test_essential_dof_counts():
    mesh = make_cartesian_3d(2, 2, 2)
    nd = NDSpaceHO(mesh, 2)
    ess = nd.essential_dofs(None)
    # boundary: 24 faces ⇒ 24·2k(k−1)=96 face dofs (k=2) + boundary edges:
    # edges of the boundary surface: count via brute force below
    bedges = set()
    for f in mesh.boundary:
        for i in range(4):
            a, b = int(f[i]), int(f[(i + 1) % 4])
            bedges.add((min(a, b), max(a, b)))
    expect = 24 * 2 * 2 * 1 + len(bedges) * 2
    assert len(ess) == expect, (len(ess), expect)

    rt = RTSpaceHO(mesh, 2)
    ess_rt = rt.essential_dofs(None)
    assert len(ess_rt) == 24 * 4        # (k+1)² = 4 per boundary face


def _solve_divdiv_varcoeff(n, order):
    """Spatially varying scalar coefficient in the div-div term
    (DivDivIntegrator(Coefficient&), fem/bilininteg.hpp:3130):
    (σ, τ) + (c div σ, div τ) = (f, τ) with c = 1 + x,
    exact σ as in _solve_divdiv ⇒ f = σ − ∇(c ∇·σ)."""
    mesh = make_cartesian_3d(n, n, n)
    space = RTSpaceHO(mesh, order)
    op = build_rt_operator(space, mass_coeff=1.0,
                           divdiv_coeff=lambda x: 1.0 + x[..., 0],
                           nq1d=order + 2)

    def sig(x):
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        return np.stack([
            s[..., 0] * c[..., 1] * c[..., 2],
            c[..., 0] * s[..., 1] * c[..., 2],
            c[..., 0] * c[..., 1] * s[..., 2],
        ], axis=-1)

    def f(x):
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        C = c[..., 0] * c[..., 1] * c[..., 2]
        cx = 1.0 + x[..., 0]
        grad = 3 * np.pi * np.stack([
            C - np.pi * cx * s[..., 0] * c[..., 1] * c[..., 2],
            -np.pi * cx * c[..., 0] * s[..., 1] * c[..., 2],
            -np.pi * cx * c[..., 0] * c[..., 1] * s[..., 2],
        ], axis=-1)
        return sig(x) - grad

    b = vecfe_linear_form(op, f)
    ess = space.essential_dofs(None)
    mask = np.zeros(space.ndof)
    mask[ess] = 1.0
    mask = jnp.asarray(mask)

    def Aop(x):
        y = op.mult(x * (1 - mask))
        return y * (1 - mask) + x * mask

    dg = op.diagonal()
    x, info = cg(Aop, b * (1 - mask),
                 M=lambda r: r / jnp.where(mask > 0, 1.0, dg),
                 rel_tol=1e-11, max_iter=6000)
    _, _, Bq = next(t for t in op.terms if t[0] == "mass")
    e = x[op.gather] * op.signs
    vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
    ex = sig(np.asarray(op.gf.x))
    w = np.asarray(op.gf.wdet)
    return np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2))


def test_divdiv_variable_coefficient_converges():
    e1 = _solve_divdiv_varcoeff(2, 2)
    e2 = _solve_divdiv_varcoeff(4, 2)
    rate = np.log2(e1 / e2)
    assert rate > 1.6, (e1, e2, rate)
    assert e2 < 0.03
