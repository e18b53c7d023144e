"""Masked-lattice structured path ≡ generic unstructured path.

The carved cardiac hex problem solved two ways on IDENTICAL geometry
(same jitter/warp seed): (a) generic FESpace over the carved mesh,
(b) CartesianFESpace over the full lattice with elem_mask +
masked_lattice_essential.  Removed elements contribute exactly zero, so
the free-dof operators are identical and one implicit SDIRK33 step must
agree to solver tolerance (fem/masked_lattice.py docstring).
"""

import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.cartesian import CartesianFESpace
from cardiac_ablation_ecm2.fem.fespace import element_node_coords
from cardiac_ablation_ecm2.fem.masked_lattice import (
    masked_lattice_essential,
)
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh.cardiac import (
    make_cardiac_hex_lattice,
    make_cardiac_hex_mesh,
)
from cardiac_ablation_ecm2.models import bioheat


def _step(op, fes, dt=0.25):
    solver = ode.select("sdirk33")
    T0 = jnp.zeros(fes.ndof, jnp.float64)
    T1, _ = solver.step(op, T0, jnp.float64(0.0), jnp.float64(dt))
    return np.asarray(T1)


def test_masked_lattice_matches_generic():
    n = 10
    L = (40.0, 40.0, 20.0)
    kw = dict(rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
              rel_tol=1e-12, max_iter=800, dtype="float64",
              theta_form=True)
    ctr = np.array([L[0] / 2, L[1] / 2, L[2]])

    def src(x):
        r2 = ((x - ctr) ** 2).sum(axis=-1)
        return 5e6 * jnp.exp(-r2 / (2.0 * 3.0 ** 2))

    carved = make_cardiac_hex_mesh(n, lengths=L)
    fes_g = FESpace(carved, 2)
    op_g = bioheat.BioheatOperator(fes=fes_g, q_met=src,
                                   ess_bdr=[1, 2, 3], **kw)
    Tg = _step(op_g, fes_g)

    full, keep, ns = make_cardiac_hex_lattice(n, lengths=L)
    fes_s = CartesianFESpace(full, 2, ns, L)
    ess = masked_lattice_essential(ns, 2, keep)
    op_s = bioheat.BioheatOperator(fes=fes_s, q_met=src,
                                   elem_mask=keep.astype(np.float64),
                                   ess_dofs=ess, **kw)
    Ts = _step(op_s, fes_s)

    # dof correspondence by physical coordinates
    Xe = element_node_coords(full, 2)
    coords_s = np.zeros((fes_s.ndof, 3))
    coords_s[fes_s.gather_map.reshape(-1)] = Xe.reshape(-1, 3)
    tree = cKDTree(coords_s)
    d, idx = tree.query(fes_g.dof_coords)
    assert d.max() < 1e-9, "dof coordinate matching failed"

    err = np.abs(Tg - Ts[idx]).max()
    rise = np.abs(Tg).max()
    assert rise > 1e-3            # the step actually heated something
    assert err < 1e-8 * max(1.0, rise), f"mismatch {err} at rise {rise}"

    # the carved region is pinned: inactive dofs stay exactly zero
    free = np.ones(fes_s.ndof, bool)
    free[ess] = False
    assert np.all(Ts[~free][np.abs(Ts[~free]) > 0] == 0.0)


def test_essential_set_matches_carved_boundary():
    n = 8
    L = (40.0, 40.0, 20.0)
    carved = make_cardiac_hex_mesh(n, lengths=L)
    fes_g = FESpace(carved, 2)
    ess_g = fes_g.essential_dofs([1, 2, 3])

    full, keep, ns = make_cardiac_hex_lattice(n, lengths=L)
    fes_s = CartesianFESpace(full, 2, ns, L)
    ess_s = masked_lattice_essential(ns, 2, keep)

    # count of FREE dofs must match (free sets are the same physical nodes)
    free_g = fes_g.ndof - len(ess_g)
    free_s = fes_s.ndof - len(ess_s)
    assert free_g == free_s
