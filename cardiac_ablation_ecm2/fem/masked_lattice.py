"""Masked-lattice (inactive-element) support for structured spaces.

Carved lattice-topology geometries — e.g. the cardiac hex mesh's electrode
notch (``mesh/cardiac.make_cardiac_hex_lattice``) — can run on the
gather-free ``CartesianFESpace`` restriction instead of the generic
unstructured gather path: the removed elements' qdata is zeroed
(``BioheatOperator.elem_mask``), which makes their element matrices exactly
zero, and every dof that is not strictly interior to the kept region is
pinned as essential.  The discrete operator restricted to the free dofs is
then IDENTICAL to the one assembled on the carved mesh (same element
contributions, same quadrature), so this is equivalence-by-construction,
not an approximation.

The reference has no analog (its answer is remeshing / SubMesh); this is a
Design: profiling shows the unstructured L↔E gather/scatter is
~94% of the CG apply at 912k dofs (benchmarks/roofline.py), while the
structured restriction is reshape/slice-only.
"""

from __future__ import annotations

import numpy as np


def masked_lattice_essential(shape_n, order: int, keep: np.ndarray,
                             outer_essential: bool = True) -> np.ndarray:
    """Essential dof ids of the carved problem on the FULL dof lattice.

    A dof is FREE iff every lattice element touching it is kept (so it sees
    only fully-assembled rows) and — when ``outer_essential`` — it is not on
    the outer box boundary.  Everything else (outer boundary, carved
    surface, dofs only inside the carved region) is pinned.

    ``shape_n``: elements per axis (nx, ny, nz); ``keep``: (ne,) bool in the
    x-fastest element order of ``CartesianFESpace``/``make_cartesian_3d``.
    Returns sorted int32 dof ids in the lattice numbering
    ``gx + Nx*(gy + Ny*gz)``.
    """
    p = int(order)
    ns = tuple(int(v) for v in shape_n)
    if len(ns) != 3:
        raise NotImplementedError("masked lattice: 3D only")
    nx, ny, nz = ns
    keep3 = np.asarray(keep, bool).reshape(nz, ny, nx)   # [ez, ey, ex]

    def axis_windows(n):
        i = np.arange(p * n + 1)
        e_lo = np.maximum(0, (i - 1) // p)
        e_hi = np.minimum(n - 1, i // p)
        return e_lo, e_hi

    xlo, xhi = axis_windows(nx)
    ylo, yhi = axis_windows(ny)
    zlo, zhi = axis_windows(nz)

    allkept = np.ones((len(zlo), len(ylo), len(xlo)), dtype=bool)
    for ez in (zlo, zhi):
        for ey in (ylo, yhi):
            for ex in (xlo, xhi):
                allkept &= keep3[np.ix_(ez, ey, ex)]

    free = allkept
    if outer_essential:
        interior = np.zeros_like(free)
        interior[1:-1, 1:-1, 1:-1] = True
        free = free & interior
    return np.nonzero(~free.reshape(-1))[0].astype(np.int32)


def masked_lattice_active_count(shape_n, order: int,
                                keep: np.ndarray) -> int:
    """Number of dofs touched by ≥1 kept element — exactly the carved
    mesh's dof count (for apples-to-apples DOF/s reporting: the full
    lattice also numbers dofs strictly inside the carved region)."""
    p = int(order)
    nx, ny, nz = (int(v) for v in shape_n)
    keep3 = np.asarray(keep, bool).reshape(nz, ny, nx)

    def axis_windows(n):
        i = np.arange(p * n + 1)
        return np.maximum(0, (i - 1) // p), np.minimum(n - 1, i // p)

    xlo, xhi = axis_windows(nx)
    ylo, yhi = axis_windows(ny)
    zlo, zhi = axis_windows(nz)
    any_kept = np.zeros((len(zlo), len(ylo), len(xlo)), dtype=bool)
    for ez in (zlo, zhi):
        for ey in (ylo, yhi):
            for ex in (xlo, xhi):
                any_kept |= keep3[np.ix_(ez, ey, ex)]
    return int(any_kept.sum())
