"""Cached per-space build products: restrictions, geometric factors, device
bases.  (The reference caches these inside FiniteElementSpace/Mesh; here they
are memoized free functions keyed on space identity.)"""

from __future__ import annotations

import functools
from typing import Optional

from ..utils.config import real_t
from .fespace import element_node_coords
from .geom_factors import GeometricFactors, compute_geometric_factors
from .quadinterp import DeviceBasis, device_basis
from .restriction import ElementRestriction


@functools.lru_cache(maxsize=None)
def restriction_for(fes):
    # Cartesian spaces carry a gather-free structured restriction (see
    # fem/cartesian.py); unstructured spaces gather and segment-sum.
    if hasattr(fes, "restriction"):
        return fes.restriction
    return ElementRestriction.for_space(fes)


@functools.lru_cache(maxsize=None)
def bdr_restriction_for(fes) -> ElementRestriction:
    return ElementRestriction.from_map(fes.bdr_gather_map, fes.ndof_scalar)


@functools.lru_cache(maxsize=None)
def _geom_factors_cached(fes, nq1d, dtype_str) -> GeometricFactors:
    mesh = fes.mesh
    d2q = fes.dof_to_quad(nq1d)
    X = element_node_coords(mesh, fes.order)
    return compute_geometric_factors(X, d2q, dtype=dtype_str)


def geom_factors_for(fes, nq1d: Optional[int] = None, dtype=None) -> GeometricFactors:
    """Isoparametric geometric factors at the space's quadrature rule
    (Mesh::GetGeometricFactors analog, mesh/mesh.cpp:15195)."""
    return _geom_factors_cached(fes, nq1d, str(real_t(dtype)))


def basis_for(fes, nq1d: Optional[int] = None, dtype=None) -> DeviceBasis:
    return device_basis(fes.dof_to_quad(nq1d), dtype)
