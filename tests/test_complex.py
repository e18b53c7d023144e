"""Complex-valued FEM: ComplexOperator 2×2 block form, SesquilinearForm,
and the ex22/ex25 example classes.

Reference analogs: ``linalg/complex_operator.hpp:68`` (conventions),
``fem/complex_fem.hpp:308`` (SesquilinearForm), ``examples/ex22.cpp``
(damped harmonic oscillator on H1/ND), ``examples/ex25.cpp`` (Maxwell
with a Cartesian PML; the beam case has the exact T_10-style solution
E = (0, e^{ikx}) in the physical region)."""

import numpy as np
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
from cardiac_ablation_ecm2.linalg.solvers import gmres
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.ops.complex_fem import (
    BLOCK_SYMMETRIC, ComplexGridFunction, ComplexOperator, SesquilinearForm,
    complex_jacobi, cstack, form_complex_linear_system)
from cardiac_ablation_ecm2.ops.linearform import domain_lf
from cardiac_ablation_ecm2.ops.operators import LinearOperator
from cardiac_ablation_ecm2.ops.vecfe import build_nd_operator


def test_conventions_match_dense_complex():
    """Block mult reproduces (A_r + iA_i)x; BLOCK_SYMMETRIC returns the
    conjugate (complex_operator.hpp:40-48)."""
    rng = np.random.default_rng(3)
    n = 23
    Ar, Ai = rng.standard_normal((2, n, n))
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = (Ar + 1j * Ai) @ x

    mk = lambda M: LinearOperator((n, n), lambda v: jnp.asarray(M) @ v,
                                  lambda: jnp.asarray(np.diag(M)))
    z = cstack(jnp.asarray(x.real), jnp.asarray(x.imag))

    A = ComplexOperator(mk(Ar), mk(Ai), n)
    y = np.asarray(A.mult(z))
    assert np.allclose(y[:n] + 1j * y[n:], want, atol=1e-12)

    As = ComplexOperator(mk(Ar), mk(Ai), n, convention=BLOCK_SYMMETRIC)
    ys = np.asarray(As.mult(z))
    assert np.allclose(ys[:n] + 1j * ys[n:], np.conj(want), atol=1e-12)

    # None parts are zero
    A0 = ComplexOperator(None, mk(Ai), n)
    y0 = np.asarray(A0.mult(z))
    assert np.allclose(y0[:n] + 1j * y0[n:], (1j * Ai) @ x, atol=1e-12)


def _solve_damped_h1(n, order=2, omega=2.0, sigma=1.0, conv="hermitian"):
    """ex22 prob-0 analog: (∇u,∇v) − ω²(u,v) + iωσ(u,v) = (f,v), u=0 on ∂Ω,
    manufactured u = (1 + 0.5i)·sin(πx)sin(πy)."""
    mesh = make_cartesian_2d(n, n)
    fes = FESpace(mesh, order)
    amp = 1.0 + 0.5j
    lam = 2 * np.pi**2 - omega**2 + 1j * omega * sigma

    def s(x):
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    sesq = SesquilinearForm(fes, convention=conv)
    sesq.add_domain_integrator("diffusion", 1.0, None)
    sesq.add_domain_integrator("mass", -omega**2, omega * sigma)
    A = sesq.assemble()

    b = cstack(domain_lf(fes, lambda x: (lam * amp).real * s(x)),
               domain_lf(fes, lambda x: (lam * amp).imag * s(x)))
    if conv == BLOCK_SYMMETRIC:
        b = cstack(b[:fes.ndof], -b[fes.ndof:])
    ess = fes.essential_dofs([1, 2, 3, 4])
    Ac, B = form_complex_linear_system(
        A, ess, jnp.zeros(2 * fes.ndof), b)
    mask = np.zeros(fes.ndof)
    mask[ess] = 1.0
    M = complex_jacobi(A, ess_mask=jnp.asarray(mask))
    z, info = gmres(Ac.mult, B, M=M, rel_tol=1e-12, max_iter=2000,
                    restart=200)
    u = ComplexGridFunction.from_vec(fes, z)
    err = u.l2_error(lambda x: amp.real * s(x), lambda x: amp.imag * s(x))
    return err, info


def test_ex22_h1_damped_convergence():
    e1, i1 = _solve_damped_h1(4)
    e2, i2 = _solve_damped_h1(8)
    assert bool(i1.converged) and bool(i2.converged)
    rate = np.log2(e1 / e2)
    assert rate > 2.6, (e1, e2, rate)         # L2 rate p+1 = 3


def test_block_symmetric_same_solution():
    """Both conventions must produce the same complex field (the
    BLOCK_SYMMETRIC system is the conjugated equations)."""
    eh, _ = _solve_damped_h1(4, conv="hermitian")
    es, _ = _solve_damped_h1(4, conv=BLOCK_SYMMETRIC)
    assert abs(eh - es) < 1e-9 * max(eh, 1e-30), (eh, es)


def test_ex22_nd_damped():
    """ex22 prob-1 analog on ND₂: curl curl E − ω²E + iωσE = F with the
    div-free zero-trace manufactured E (curl curl E = 2π²E)."""
    from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form

    omega, sigma = 1.5, 0.8
    mesh = make_cartesian_3d(3, 3, 3)
    space = NDSpaceHO(mesh, 2)

    def E(x):
        s = np.sin(np.pi * x)
        return np.stack([s[..., 1] * s[..., 2], s[..., 2] * s[..., 0],
                         s[..., 0] * s[..., 1]], axis=-1)

    op_r = build_nd_operator(space, mass_coeff=-omega**2, curlcurl_coeff=1.0,
                             nq1d=4)
    op_i = build_nd_operator(space, mass_coeff=omega * sigma,
                             curlcurl_coeff=None, nq1d=4)
    A = ComplexOperator(op_r, op_i, space.ndof)

    cr = 2 * np.pi**2 - omega**2
    b = cstack(vecfe_linear_form(op_r, lambda x: cr * E(x)),
               vecfe_linear_form(op_r, lambda x: omega * sigma * E(x)))
    ess = space.essential_dofs(None)
    Ac, B = form_complex_linear_system(A, ess, jnp.zeros(2 * space.ndof), b)
    mask = np.zeros(space.ndof)
    mask[ess] = 1.0
    M = complex_jacobi(A, ess_mask=jnp.asarray(mask))
    z, info = gmres(Ac.mult, B, M=M, rel_tol=1e-11, max_iter=4000,
                    restart=250)
    assert bool(info.converged)

    # evaluate at quadrature points (real part carries E, imag ≈ iσ-phase
    # mix — compare the full complex field against the manufactured one:
    # (curlcurl − ω² + iωσ)E = (cr + iωσ)E means the SOLUTION is E + 0i)
    _, _, Bq = next(t for t in op_r.terms if t[0] == "mass")
    w = np.asarray(op_r.gf.wdet)
    ex = E(np.asarray(op_r.gf.x))
    err2 = 0.0
    for part, exact in ((z[:space.ndof], ex), (z[space.ndof:], 0 * ex)):
        e = part[op_r.gather] * op_r.signs
        vals = np.asarray(jnp.einsum("eqnc,en->eqc", Bq, e))
        err2 += np.sum(w[..., None] * (vals - exact) ** 2)
    assert np.sqrt(err2) < 0.06, np.sqrt(err2)


def _beam_pml_error(nx, ny, order=2, k=np.pi, Lx=4.0, pml_x=3.0):
    """ex25 beam analog (2D): Maxwell curl-curl with a Cartesian PML in +x.

    Physical region x < pml_x carries the exact traveling wave
    E = (0, e^{ikx}); the PML (x ∈ [pml_x, Lx]) absorbs it.  Quadratic
    stretch d₀ = 1 + i·(n c / k L^n)·(x − pml_x)^{n−1}, n=2, c=5
    (ex25.cpp PML::StretchFunction).  2D coefficients: curl term
    μ⁻¹/(d₀d₁), mass term −ω²ε·d₀d₁·diag(1/d₀², 1/d₁²)."""
    npml, cpml = 2.0, 5.0
    Lpml = Lx - pml_x
    coeff = npml * cpml / (k * Lpml**npml)

    def dx0(x):
        """Complex stretch d₀(x) as a (..., ) complex array (host)."""
        ex = np.maximum(np.asarray(x)[..., 0] - pml_x, 0.0)
        return 1.0 + 1j * coeff * ex ** (npml - 1)

    def curl_coeff(x):        # scalar: 1/(d0·d1), d1 = 1
        return 1.0 / dx0(x)

    def mass_coeff(x):        # diag(d1/d0, d0/d1)·(−k²)
        d0 = dx0(x)
        z = np.zeros_like(d0)
        return -k**2 * np.stack([
            np.stack([1.0 / d0, z], axis=-1),
            np.stack([z, d0], axis=-1),
        ], axis=-2)

    mesh = make_cartesian_2d(nx, ny, Lx, 1.0)
    space = NDSpaceHO(mesh, order)
    op_r = build_nd_operator(
        space, mass_coeff=lambda x: mass_coeff(x).real,
        curlcurl_coeff=lambda x: curl_coeff(x).real, nq1d=order + 2)
    op_i = build_nd_operator(
        space, mass_coeff=lambda x: mass_coeff(x).imag,
        curlcurl_coeff=lambda x: curl_coeff(x).imag, nq1d=order + 2)

    # FULL-assembly complex solve (the LEGACY cross-check path): the
    # sesquilinear system is genuinely complex-symmetric — scipy splu on
    # A_r + iA_i validates the same operators the 2×2 iterative path uses.
    import scipy.sparse.linalg as spla

    A = (op_r.assemble_matrix() + 1j * op_i.assemble_matrix()).tocsc()

    # essential BCs: all boundary tangential dofs; values from the ND
    # interpolant of the constant field (0, 1) (exactly representable →
    # its L2 projection IS the interpolant), scaled by e^{ik·0}=1 on the
    # left edge, 0 elsewhere
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.ops.vecfe import vecfe_linear_form

    mass1 = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=None,
                              nq1d=order + 2)
    bconst = vecfe_linear_form(
        mass1, lambda x: np.stack([0 * x[..., 0], 1 + 0 * x[..., 0]],
                                  axis=-1))
    xconst, info = cg(mass1.mult, bconst, M=lambda r: r / mass1.diagonal(),
                      rel_tol=1e-14, max_iter=2000)
    assert bool(info.converged)

    ess = space.essential_dofs(None)
    left = space.essential_dofs([4])          # x = 0 edge
    zr = np.zeros(space.ndof)
    zr[left] = np.asarray(xconst)[left]       # Re e^{ik·0} = 1
    zc = zr + 0j

    n = space.ndof
    x_full = zc.copy()
    free = np.setdiff1d(np.arange(n), ess)
    rhs = -A[:, ess] @ zc[ess]
    x_full[free] = spla.splu(A[free][:, free]).solve(rhs[free])

    # L2 error at quadrature points, physical region only
    _, _, Bq = next(t for t in op_r.terms if t[0] == "mass")
    xq = np.asarray(op_r.gf.x)
    w = np.asarray(op_r.gf.wdet)
    phys = (xq[..., 0] < pml_x)
    exact = np.stack([np.zeros_like(xq[..., 0]),
                      np.exp(1j * k * xq[..., 0])], axis=-1)
    e = x_full[np.asarray(op_r.gather)] * np.asarray(op_r.signs)
    vals = np.einsum("eqnc,en->eqc", np.asarray(Bq), e)
    err = np.sqrt(np.sum(w[..., None] * phys[..., None] *
                         np.abs(vals - exact) ** 2))
    norm = np.sqrt(np.sum(w[..., None] * phys[..., None] *
                          np.abs(exact) ** 2))
    return err / norm


def test_ex25_beam_pml():
    """The PML absorbs the outgoing wave: the physical-region field matches
    the exact traveling wave, converging under refinement."""
    e1 = _beam_pml_error(16, 4)
    e2 = _beam_pml_error(32, 8)
    assert e2 < 0.02, (e1, e2)
    rate = np.log2(e1 / e2)
    assert rate > 1.5, (e1, e2, rate)
