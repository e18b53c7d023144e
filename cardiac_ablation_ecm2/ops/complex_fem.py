"""Complex-valued FEM via the 2×2 real block form.

Reference analog: ``ComplexOperator`` (``linalg/complex_operator.hpp:68``)
and ``SesquilinearForm`` / ``ComplexGridFunction``
(``fem/complex_fem.hpp:308`` / ``:54``), used by ex22 (damped harmonic
oscillators on H1/ND/RT) and ex25 (Maxwell with PML).

Design: a complex dof vector is the stacked real pair
``z = [x_r; x_i]`` (2n,) and the complex operator ``A = A_r + i A_i`` acts
as one of the two real 2×2 block forms (complex_operator.hpp:40-48):

    HERMITIAN        y = [A_r x_r − A_i x_i;  A_i x_r + A_r x_i]
    BLOCK_SYMMETRIC  y = [A_r x_r − A_i x_i; −A_i x_r − A_r x_i]

(BLOCK_SYMMETRIC computes conj(A x) — symmetric when A_r, A_i both are).
Both parts are ordinary matrix-free operators (PAOperator, VecFEOperator,
LinearOperator, or any ``.mult`` object), so every existing integrator —
including the H(curl)/H(div) families with matrix coefficients that ex25's
PML needs — becomes complex-capable without new kernels.  There is no
complex arithmetic on device: everything is two real streams, which keeps
the f32/bf16 paths intact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from .bilinearform import BilinearForm
from .operators import LinearOperator

HERMITIAN = "hermitian"
BLOCK_SYMMETRIC = "block_symmetric"


def _mult_of(op):
    if op is None:
        return None
    return op.mult if hasattr(op, "mult") else op


def cstack(xr: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Stack real/imag parts into the (2n,) block vector."""
    return jnp.concatenate([xr, xi])


def csplit(z: jnp.ndarray):
    n = z.shape[0] // 2
    return z[:n], z[n:]


@dataclasses.dataclass(frozen=True, eq=False)
class ComplexOperator:
    """A = A_r + i A_i acting on stacked ``[x_r; x_i]`` (2n,) vectors.

    Either part may be None (zero).  ``diagonal_parts`` returns the real
    pair (d_r, d_i) for the 2×2-block Jacobi preconditioner."""

    op_r: object
    op_i: object
    n: int
    convention: str = HERMITIAN

    def __post_init__(self):
        if self.convention not in (HERMITIAN, BLOCK_SYMMETRIC):
            raise ValueError(self.convention)

    def mult(self, z: jnp.ndarray) -> jnp.ndarray:
        xr, xi = z[: self.n], z[self.n:]
        mr, mi = _mult_of(self.op_r), _mult_of(self.op_i)
        yr = mr(xr) if mr is not None else jnp.zeros_like(xr)
        yi = mr(xi) if mr is not None else jnp.zeros_like(xi)
        if mi is not None:
            yr = yr - mi(xi)
            yi = yi + mi(xr)
        if self.convention == BLOCK_SYMMETRIC:
            yi = -yi
        return jnp.concatenate([yr, yi])

    def __call__(self, z):
        return self.mult(z)

    @property
    def shape(self):
        return (2 * self.n, 2 * self.n)

    def diagonal_parts(self):
        d_r = self.op_r.diagonal() if self.op_r is not None else None
        d_i = self.op_i.diagonal() if self.op_i is not None else None
        if d_r is None:
            d_r = jnp.zeros(self.n)
        if d_i is None:
            d_i = jnp.zeros_like(d_r)
        return d_r, d_i

    def operator(self) -> LinearOperator:
        return LinearOperator(self.shape, self.mult)


def complex_jacobi(A: "ComplexOperator", ess_mask=None) -> Callable:
    """2×2-block Jacobi: per dof invert the complex diagonal d_r + i d_i.

    HERMITIAN block  [d_r, −d_i; d_i, d_r]   → inv = [d_r, d_i; −d_i, d_r]/Δ
    BLOCK_SYMMETRIC  [d_r, −d_i; −d_i, −d_r] → inv = [d_r, −d_i; −d_i, −d_r]/Δ
    with Δ = d_r² + d_i² (±).  ``ess_mask`` (n,) 1.0 at essential dofs makes
    those rows identity (matching the constrained operator)."""
    d_r, d_i = A.diagonal_parts()
    if ess_mask is not None:
        m = jnp.asarray(ess_mask, d_r.dtype)
        d_r = d_r * (1.0 - m) + m
        d_i = d_i * (1.0 - m)
    delta = d_r * d_r + d_i * d_i
    delta = jnp.where(delta == 0, 1.0, delta)
    herm = A.convention == HERMITIAN

    def prec(z):
        rr, ri = z[: A.n], z[A.n:]
        if herm:
            return jnp.concatenate([
                (d_r * rr + d_i * ri) / delta,
                (-d_i * rr + d_r * ri) / delta,
            ])
        return jnp.concatenate([
            (d_r * rr - d_i * ri) / delta,
            (-d_i * rr - d_r * ri) / delta,
        ])

    return prec


@dataclasses.dataclass(frozen=True, eq=False)
class ComplexConstrainedOperator:
    """Essential-BC wrap of a ComplexOperator (complex_fem.cpp's
    FormLinearSystem path): the SAME dof set is constrained in both the
    real and imaginary halves, with identity rows (bottom-half −identity
    under BLOCK_SYMMETRIC so the eliminated block stays symmetric)."""

    A: ComplexOperator
    mask: jnp.ndarray          # (n,) 0.0 at constrained dofs

    @staticmethod
    def wrap(A: ComplexOperator, ess_dofs) -> "ComplexConstrainedOperator":
        m = np.ones(A.n)
        ess = np.asarray(ess_dofs)
        if ess.size:
            m[ess] = 0.0
        return ComplexConstrainedOperator(A=A, mask=jnp.asarray(m))

    @property
    def shape(self):
        return self.A.shape

    def _m2(self, dtype):
        m = self.mask.astype(dtype)
        return jnp.concatenate([m, m])

    def _sign(self, dtype):
        s = jnp.ones(self.A.n, dtype)
        if self.A.convention == BLOCK_SYMMETRIC:
            return jnp.concatenate([s, -s])
        return jnp.concatenate([s, s])

    def mult(self, z: jnp.ndarray) -> jnp.ndarray:
        m2 = self._m2(z.dtype)
        w = z * m2
        return self.A.mult(w) * m2 + (z - w) * self._sign(z.dtype)

    def __call__(self, z):
        return self.mult(z)

    def eliminate_rhs(self, z_bc: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Fold BC values (both halves) into the block RHS."""
        m2 = self._m2(z_bc.dtype)
        w = z_bc * (1.0 - m2)
        bmod = b - self.A.mult(w)
        return bmod * m2 + w * self._sign(z_bc.dtype)


def form_complex_linear_system(A: ComplexOperator, ess_dofs,
                               z_bc: jnp.ndarray, b: jnp.ndarray):
    """SesquilinearForm::FormLinearSystem analog (fem/complex_fem.cpp):
    returns (A_constrained, B).  The solution Z of A_constrained Z = B has
    Z[ess] = z_bc[ess] in both halves."""
    Ac = ComplexConstrainedOperator.wrap(A, ess_dofs)
    return Ac, Ac.eliminate_rhs(z_bc, b)


class SesquilinearForm:
    """Paired-integrator front-end for scalar/H1 spaces
    (fem/complex_fem.hpp:308).  ``add_domain_integrator(kind, coeff_real,
    coeff_imag)`` mirrors ``AddDomainIntegrator(bfi_real, bfi_imag)``;
    passing None for a side omits that part (complex_fem allows NULL).

    For H(curl)/H(div) systems (ex25-class) build the two parts directly
    with ``ops.vecfe.build_nd_operator`` / ``build_rt_operator`` — complex
    PML coefficients split into real/imag matrix callables — and wrap them
    in :class:`ComplexOperator`."""

    def __init__(self, fes, convention: str = HERMITIAN,
                 nq1d: Optional[int] = None):
        self.fes = fes
        self.convention = convention
        self._br = BilinearForm(fes, nq1d)
        self._bi = BilinearForm(fes, nq1d)
        self._has_r = False
        self._has_i = False

    def add_domain_integrator(self, kind: str, coeff_real=None,
                              coeff_imag=None, **kw):
        if coeff_real is None and coeff_imag is None:
            raise ValueError("at least one of coeff_real/coeff_imag")
        if coeff_real is not None:
            self._br.add_domain_integrator(kind, coeff_real, **kw)
            self._has_r = True
        if coeff_imag is not None:
            self._bi.add_domain_integrator(kind, coeff_imag, **kw)
            self._has_i = True
        return self

    def add_boundary_integrator(self, kind: str, coeff_real=None,
                                coeff_imag=None, marker=None):
        if coeff_real is not None:
            self._br.add_boundary_integrator(kind, coeff_real, marker=marker)
            self._has_r = True
        if coeff_imag is not None:
            self._bi.add_boundary_integrator(kind, coeff_imag, marker=marker)
            self._has_i = True
        return self

    def assemble(self, dtype=None) -> ComplexOperator:
        op_r = self._br.assemble(dtype).operator() if self._has_r else None
        op_i = self._bi.assemble(dtype).operator() if self._has_i else None
        n = self.fes.ndof
        return ComplexOperator(op_r=op_r, op_i=op_i, n=n,
                               convention=self.convention)


@dataclasses.dataclass(eq=False)
class ComplexGridFunction:
    """(real, imag) dof pair (fem/complex_fem.hpp:54)."""

    fes: object
    re: jnp.ndarray
    im: jnp.ndarray

    @staticmethod
    def zero(fes, dtype=None) -> "ComplexGridFunction":
        z = jnp.zeros(fes.ndof, dtype=dtype)
        return ComplexGridFunction(fes, z, z)

    @staticmethod
    def project(fes, f_real: Callable, f_imag: Callable,
                dtype=None) -> "ComplexGridFunction":
        from ..fem.gridfunction import project

        return ComplexGridFunction(
            fes, project(fes, f_real, dtype), project(fes, f_imag, dtype))

    def vec(self) -> jnp.ndarray:
        return cstack(self.re, self.im)

    @staticmethod
    def from_vec(fes, z: jnp.ndarray) -> "ComplexGridFunction":
        n = z.shape[0] // 2
        return ComplexGridFunction(fes, z[:n], z[n:])

    def l2_error(self, exact_real: Callable, exact_imag: Callable,
                 nq1d=None) -> float:
        from ..fem.gridfunction import l2_error

        er = l2_error(self.fes, self.re, exact_real, nq1d)
        ei = l2_error(self.fes, self.im, exact_imag, nq1d)
        return float(np.sqrt(er * er + ei * ei))
