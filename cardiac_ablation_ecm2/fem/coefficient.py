"""Coefficients: functions evaluated at quadrature points.

Reference analog: the ~80-class ``Coefficient`` algebra
(``fem/coefficient.hpp:41-2636``).  This package replaces the class tree
with plain values and callables — the natural JAX idiom:

* ``None`` → unit coefficient
* python scalar / 0-d array → constant (``ConstantCoefficient``)
* callable ``f(x)`` with ``x (..., sdim)`` → function coefficient, evaluated
  vectorized at the physical quadrature points (``FunctionCoefficient``)
* jnp/np array of shape (ne, nq)[, ...] → precomputed Q-vector
  (``QuadratureFunctionCoefficient``, fem/qfunction.cpp)
* ``GridFunctionCoefficient`` → use :func:`gridfunction_coefficient` to turn a
  dof vector into a Q-vector
* piecewise-by-attribute → :func:`attribute_coefficient`

Algebraic combinators (Sum/Product/Ratio/Power…) are ordinary Python on the
evaluated Q-vectors or lambda composition — no classes needed.
"""

from __future__ import annotations

from typing import Callable, Union

import jax.numpy as jnp
import numpy as np

from ..utils.config import real_t
from .geom_factors import GeometricFactors

Coefficient = Union[None, float, int, jnp.ndarray, np.ndarray, Callable]


def eval_coeff(coeff: Coefficient, gf: GeometricFactors, dtype=None):
    """Evaluate a scalar coefficient to an (ne, nq) Q-vector (or None)."""
    if coeff is None:
        return None
    if callable(coeff):
        return jnp.asarray(coeff(gf.x), dtype=real_t(dtype))
    arr = jnp.asarray(coeff, dtype=real_t(dtype))
    if arr.ndim == 0:
        return jnp.broadcast_to(arr, gf.det.shape)
    return arr


def attribute_coefficient(values: dict, default=0.0):
    """Piecewise-constant-by-attribute (PWConstCoefficient analog).

    Returns a function of (gf, attributes (ne,)) → (ne, nq); use with
    :func:`eval_attr_coeff`."""

    def make(attributes: np.ndarray, nq: int, dtype=None):
        out = np.full(len(attributes), default, dtype=float)
        for attr, v in values.items():
            out[attributes == attr] = v
        arr = jnp.asarray(out, dtype=real_t(dtype))
        return jnp.broadcast_to(arr[:, None], (len(attributes), nq))

    return make
