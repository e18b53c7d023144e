"""Operator algebra and essential-BC constrained operators.

Reference analog: ``linalg/operator.hpp`` — abstract ``Operator::Mult``
(``operator.hpp:89``), composition operators (``operator.hpp:848-1047``),
``ConstrainedOperator`` (``operator.hpp:1049``, impl ``operator.cpp:559,710``)
and ``Operator::FormLinearSystem`` (``operator.cpp:114``).

Design: an operator is a pure function ``x -> A x`` plus a little
metadata; composition is function composition.  Everything is jit-safe: the
essential-dof list is a static device array captured in the closure, and BC
elimination uses scatter/gather rather than matrix surgery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.config import index_t


@dataclasses.dataclass(frozen=True, eq=False)
class LinearOperator:
    """A linear operator y = mult(x) on flat dof vectors."""

    shape: Tuple[int, int]
    mult: Callable[[jnp.ndarray], jnp.ndarray]
    diagonal_fn: Optional[Callable[[], jnp.ndarray]] = None

    def __call__(self, x):
        return self.mult(x)

    @property
    def height(self):
        return self.shape[0]

    @property
    def width(self):
        return self.shape[1]

    def diagonal(self) -> jnp.ndarray:
        if self.diagonal_fn is None:
            raise NotImplementedError("operator has no diagonal assembly")
        return self.diagonal_fn()

    # -- algebra (operator.hpp:848-1047 analogs) -----------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        diag = None
        if self.diagonal_fn is not None and other.diagonal_fn is not None:
            diag = lambda: self.diagonal() + other.diagonal()
        return LinearOperator(
            self.shape, lambda x: self.mult(x) + other.mult(x), diag
        )

    def __rmul__(self, a) -> "LinearOperator":
        diag = None if self.diagonal_fn is None else (lambda: a * self.diagonal())
        return LinearOperator(self.shape, lambda x: a * self.mult(x), diag)

    def scaled_add(self, a, other: "LinearOperator", b=1.0) -> "LinearOperator":
        """a*self + b*other (the reference's Add/SumOperator)."""
        diag = None
        if self.diagonal_fn is not None and other.diagonal_fn is not None:
            diag = lambda: a * self.diagonal() + b * other.diagonal()
        return LinearOperator(
            self.shape, lambda x: a * self.mult(x) + b * other.mult(x), diag
        )


def identity(n: int) -> LinearOperator:
    return LinearOperator((n, n), lambda x: x, lambda: jnp.ones(n))


@dataclasses.dataclass(frozen=True, eq=False)
class ConstrainedOperator:
    """Essential-BC constrained wrapper (linalg/operator.hpp:1049).

    mult:  z = x with ess dofs zeroed; y = A z; y[ess] = x[ess].
    Realized with a precomputed 0/1 mask — an elementwise multiply instead
    of two scatters (.at[].set) in every CG iteration.
    """

    op: LinearOperator
    ess_dofs: jnp.ndarray   # (ness,) int32, static shape
    mask: jnp.ndarray       # (n,) 0.0 at constrained dofs, 1.0 elsewhere

    @staticmethod
    def wrap(op: LinearOperator, ess_dofs) -> "ConstrainedOperator":
        ess = np.asarray(ess_dofs)
        m = np.ones(op.shape[0])
        if ess.size:
            m[ess] = 0.0
        return ConstrainedOperator(
            op=op, ess_dofs=jnp.asarray(ess, dtype=index_t()),
            mask=jnp.asarray(m),
        )

    @property
    def shape(self):
        return self.op.shape

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        m = self.mask.astype(x.dtype)
        z = x * m
        return self.op.mult(z) * m + (x - z)

    def __call__(self, x):
        return self.mult(x)

    def diagonal(self) -> jnp.ndarray:
        d = self.op.diagonal()
        m = self.mask.astype(d.dtype)
        return d * m + (1.0 - m)

    def eliminate_rhs(self, x_bc: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """EliminateRHS (operator.cpp:710): fold BC values into the RHS."""
        m = self.mask.astype(x_bc.dtype)
        w = x_bc * (1.0 - m)
        bmod = b - self.op.mult(w)
        return bmod * m + w


def form_linear_system(
    op: LinearOperator, ess_dofs, x_bc: jnp.ndarray, b: jnp.ndarray
):
    """FormLinearSystem (fem/bilinearform.cpp:824 / operator.cpp:114):
    returns (A_constrained, B) with BC values eliminated into B; the solution
    of A_constrained X = B satisfies X[ess] = x_bc[ess]."""
    A = ConstrainedOperator.wrap(op, ess_dofs)
    B = A.eliminate_rhs(x_bc, b)
    return A, B
