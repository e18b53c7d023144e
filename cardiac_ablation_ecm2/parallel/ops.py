"""Device-local kernels for sharded operator application.

These functions run *inside* ``shard_map``: every array argument is this
device's slice (leading device axis already stripped).  The halo exchange is
the ppermute schedule built by ``pfespace.build`` (reference analog:
``GroupCommunicator::Bcast/Reduce``, general/communication.cpp:724,923 —
here fused into one symmetric partial-sum exchange between devices).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax


AXIS = "d"


def local_scatter(y_e, perm, seg, nloc):
    """E→L scatter-add on this device: (ne_loc, nd) → (nloc+1,) with trash
    slot cleared."""
    flat = y_e.reshape(-1)[perm]
    y = jax.ops.segment_sum(
        flat, seg, num_segments=nloc + 1, indices_are_sorted=True
    )
    return y.at[nloc].set(0.0)


def halo_sum(y, send_idx, perms, nloc, axis_name: str = AXIS):
    """Add partners' partial sums at shared dofs (one ppermute per color).

    ``y`` must already have a zeroed trash slot; each round sends the
    *pre-exchange* partials so k-way shared dofs (k > 2) sum correctly.
    """
    y0 = y
    for c, perm in enumerate(perms):
        if not perm:
            continue
        buf = y0[send_idx[c]]
        recv = lax.ppermute(buf, axis_name, perm)
        y = y.at[send_idx[c]].add(recv)
    return y.at[nloc].set(0.0)


def make_pdot(weight, axis_name: str = AXIS, f64: bool = True):
    """Multiplicity-weighted global inner product (IterativeSolver::Dot
    analog — MPI_Allreduce → lax.psum, linalg/solvers.cpp:58)."""

    def pdot(a, b):
        x = a * weight * b
        if f64 and jax.config.jax_enable_x64 and x.dtype != jnp.float64:
            s = jnp.sum(x.astype(jnp.float64))
        else:
            s = jnp.sum(x)
        s = lax.psum(s, axis_name)
        return s.astype(a.dtype)

    return pdot


def zero_at(v, idx):
    """Zero entries at (padded) local indices; pads point at the trash slot."""
    return v.at[idx].set(0.0)
