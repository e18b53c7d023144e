"""Lane-major transposed apply (ops/lanemajor.py) vs the staged
sum-factorized path and vs FULL assembly.

Reference analog of the cross-check idiom:
``tests/unit/fem/test_assembly_levels.cpp`` (PA vs LEGACY agreement).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)
from cardiac_ablation_ecm2.ops import BilinearForm
from cardiac_ablation_ecm2.utils.config import config, configure


def _mesh(dim, simplex=False):
    if dim == 2:
        return make_cartesian_2d_tri(3, 3) if simplex else make_cartesian_2d(3, 3)
    return make_cartesian_3d_tet(2, 2, 2) if simplex else make_cartesian_3d(2, 2, 2)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("kinds", [("mass",), ("diffusion",),
                                   ("mass", "diffusion")])
def test_lane_matches_staged(dim, order, kinds):
    fes = FESpace(_mesh(dim), order)
    rng = np.random.default_rng(42 + dim + order)
    x = jnp.asarray(rng.standard_normal(fes.ndof))

    def build():
        a = BilinearForm(fes)
        for k in kinds:
            a.add_domain_integrator(k, coeff=2.0 if k == "mass" else None)
        return a.assemble()

    old = config.lane_major
    try:
        configure(lane_major="auto")
        A_lane = build()
        assert A_lane.lane is not None, "lane path not engaged"
        y_lane = np.asarray(A_lane.mult(x))
        configure(lane_major="off")
        A_std = build()
        assert A_std.lane is None
        y_std = np.asarray(A_std.mult(x))
    finally:
        configure(lane_major=old)
    scale = np.abs(y_std).max()
    assert np.abs(y_lane - y_std).max() <= 1e-12 * scale


@pytest.mark.parametrize("order", [1, 2])
def test_lane_simplex_matches_full(order):
    """Non-tensor (tet) bases use db.B/db.G directly as the full matrices."""
    fes = FESpace(_mesh(3, simplex=True), order)
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A = a.assemble()
    assert A.lane is not None
    Afull = a.assemble_matrix()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(fes.ndof)
    y = np.asarray(A.mult(jnp.asarray(x)))
    yref = Afull @ x
    assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max()


def test_boundary_term_falls_back():
    """Robin boundary mass stays on the std path; sum still matches FULL."""
    fes = FESpace(_mesh(2), 2)
    a = (BilinearForm(fes)
         .add_domain_integrator("diffusion")
         .add_boundary_integrator("mass", coeff=3.0))
    A = a.assemble()
    assert A.lane is not None and len(A.std_terms) == 1
    Afull = a.assemble_matrix()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(fes.ndof)
    y = np.asarray(A.mult(jnp.asarray(x)))
    yref = Afull @ x
    assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max()


def test_bioheat_lane_on_tets():
    """BioheatOperator's transposed apply now engages on simplex meshes."""
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    fes = FESpace(_mesh(3, simplex=True), 2)
    op = BioheatOperator(fes, rho_c=1.0, k=1.0, ess_bdr=[1, 2, 3, 4, 5, 6])
    assert op._lane is not None
    op_ref = BioheatOperator(fes, rho_c=1.0, k=1.0,
                             ess_bdr=[1, 2, 3, 4, 5, 6],
                             transposed_apply=False)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal(fes.ndof))
    y1 = np.asarray(op._implicit_lhs_apply(0.3, v))
    y2 = np.asarray(op_ref._implicit_lhs_apply(0.3, v))
    assert np.abs(y1 - y2).max() <= 1e-11 * np.abs(y2).max()


# ---------------------------------------------------------------------------
# affine fast path (separable qdata → reference-matrix apply)
# ---------------------------------------------------------------------------


def _jitter_mesh(mesh, amp=0.08, seed=5):
    """Randomly displace interior vertices — tets stay affine (straight),
    hexes become genuinely trilinear (non-affine)."""
    import dataclasses as dc

    v = np.asarray(mesh.vertices).copy()
    rng = np.random.default_rng(seed)
    lo, hi = v.min(axis=0), v.max(axis=0)
    interior = np.all((v > lo + 1e-12) & (v < hi - 1e-12), axis=1)
    h = (hi - lo).max() / 4
    v[interior] += amp * h * rng.uniform(-1, 1, size=v[interior].shape)
    return dc.replace(mesh, vertices=v)


@pytest.mark.parametrize("order", [1, 2])
def test_affine_engages_on_random_tets(order):
    """Jittered tet meshes are still affine: the collapse is detected and
    the apply matches FULL assembly exactly."""
    fes = FESpace(_jitter_mesh(_mesh(3, simplex=True)), order)
    a = (BilinearForm(fes)
         .add_domain_integrator("mass", coeff=2.0)
         .add_domain_integrator("diffusion"))
    A = a.assemble()
    assert A.lane is not None
    assert len(A.lane.aff_terms) == 2 and not A.lane.terms, (
        "affine collapse not detected on a straight-sided tet mesh")
    Afull = a.assemble_matrix()
    rng = np.random.default_rng(11)
    x = rng.standard_normal(fes.ndof)
    y = np.asarray(A.mult(jnp.asarray(x)))
    yref = Afull @ x
    assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max()


def test_affine_falls_back_on_trilinear_hexes():
    """Jittered hexes are NOT affine: detection must reject them and the
    general lane path must still match FULL assembly."""
    fes = FESpace(_jitter_mesh(_mesh(3)), 2)
    a = BilinearForm(fes).add_domain_integrator("diffusion")
    A = a.assemble()
    assert A.lane is not None
    assert not A.lane.aff_terms and len(A.lane.terms) == 1, (
        "affine collapse wrongly engaged on a non-affine mesh")
    Afull = a.assemble_matrix()
    rng = np.random.default_rng(12)
    x = rng.standard_normal(fes.ndof)
    y = np.asarray(A.mult(jnp.asarray(x)))
    yref = Afull @ x
    assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max()


def test_affine_rejects_varying_coefficient():
    """A spatially varying coefficient breaks separability — must fall back."""
    fes = FESpace(_mesh(3, simplex=True), 2)
    a = BilinearForm(fes).add_domain_integrator(
        "diffusion", coeff=lambda x: 1.0 + x[..., 0])
    A = a.assemble()
    assert A.lane is not None and not A.lane.aff_terms
    Afull = a.assemble_matrix()
    rng = np.random.default_rng(13)
    x = rng.standard_normal(fes.ndof)
    y = np.asarray(A.mult(jnp.asarray(x)))
    yref = Afull @ x
    assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max()


def test_bioheat_affine_on_tets():
    """Bioheat engages the affine path on tets; applies match the staged
    path; perfusion + gamma folding included."""
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    fes = FESpace(_jitter_mesh(_mesh(3, simplex=True)), 2)
    kw = dict(rho_c=2.0, k=0.7, w_cb=3.0, T_a=37.0,
              ess_bdr=[1, 2, 3, 4, 5, 6])
    op = BioheatOperator(fes, **kw)
    assert op._aff is not None
    op_ref = BioheatOperator(fes, **kw, transposed_apply=False)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal(fes.ndof))
    for g in (0.0, 0.31):
        y1 = np.asarray(op._implicit_lhs_apply(g, v))
        y2 = np.asarray(op_ref._implicit_lhs_apply(g, v))
        assert np.abs(y1 - y2).max() <= 1e-11 * np.abs(y2).max()
    yA1 = np.asarray(op._A_apply(v))
    yA2 = np.asarray(op_ref._A_apply(v))
    assert np.abs(yA1 - yA2).max() <= 1e-11 * np.abs(yA2).max()
    yM1 = np.asarray(op._Mrc_apply(v))
    yM2 = np.asarray(op_ref._Mrc_apply(v))
    assert np.abs(yM1 - yM2).max() <= 1e-11 * np.abs(yM2).max()


def test_geometric_affine_on_f32_sliver_tets():
    """f32 qdata on bad-quality tets carries ~1e-3 adjugate roundoff, so
    NUMERICAL separability detection fails — but straight tets are affine
    by construction and the host-f64 geometric detector must engage (this
    is exactly the cardiac Delaunay production case)."""
    from cardiac_ablation_ecm2.mesh.cardiac import make_cardiac_tet_mesh
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    old = config.dtype
    try:
        configure(dtype="float32")
        L = 0.04
        mesh = make_cardiac_tet_mesh(8, lengths=(L, L, L / 2),
                                     electrode_radius=0.004)
        fes = FESpace(mesh, 2)
        op = BioheatOperator(fes, rho_c=3.6e6, k=0.54, w_cb=2e4,
                             ess_bdr=[1, 2, 3], dtype="float32")
        assert op._aff is not None, (
            "geometric affine detection failed on a straight-tet mesh")
        op_ref = BioheatOperator(fes, rho_c=3.6e6, k=0.54, w_cb=2e4,
                                 ess_bdr=[1, 2, 3], dtype="float32",
                                 transposed_apply=False)
        rng = np.random.default_rng(4)
        v = jnp.asarray(rng.standard_normal(fes.ndof), jnp.float32)
        y1 = np.asarray(op._implicit_lhs_apply(0.25, v))
        y2 = np.asarray(op_ref._implicit_lhs_apply(0.25, v))
        # f64-geometry factors vs f32 qdata chain: agreement at f32 level
        assert np.abs(y1 - y2).max() <= 2e-5 * np.abs(y2).max()

        # BilinearForm takes the geometric path on the same mesh
        a = (BilinearForm(fes)
             .add_domain_integrator("mass")
             .add_domain_integrator("diffusion"))
        A = a.assemble(dtype="float32")
        assert A.lane is not None and len(A.lane.aff_terms) == 2
    finally:
        configure(dtype=old)


def test_affine_convection_constant_vector():
    """Constant-velocity convection on straight simplices collapses to
    adj(J)·v factors; must match FULL assembly."""
    for dim in (2, 3):
        fes = FESpace(_jitter_mesh(_mesh(dim, simplex=True)), 2)
        vel = [1.3, -0.7, 0.4][:dim]
        a = BilinearForm(fes).add_domain_integrator(
            "convection", vector_coeff=np.asarray(vel))
        A = a.assemble()
        assert A.lane is not None and len(A.lane.aff_terms) == 1, dim
        Afull = a.assemble_matrix()
        rng = np.random.default_rng(dim)
        x = rng.standard_normal(fes.ndof)
        y = np.asarray(A.mult(jnp.asarray(x)))
        yref = Afull @ x
        assert np.abs(y - yref).max() <= 1e-10 * np.abs(yref).max(), dim


def test_override_qdata_refreshes_lane_caches():
    """override(K_qd=...) must take effect under the lane/affine paths (the
    k(T)-coupled ablation step depends on this)."""
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    fes = FESpace(_mesh(3, simplex=True), 2)
    op = BioheatOperator(fes, rho_c=1.0, k=1.0, ess_bdr=[1, 2, 3, 4, 5, 6])
    assert op._lane is not None
    rng = np.random.default_rng(9)
    v = jnp.asarray(rng.standard_normal(fes.ndof))
    y1 = np.asarray(op._implicit_lhs_apply(0.5, v))
    # doubled conductivity through override — must change the result by
    # exactly the K contribution
    op2 = op.override(K_qd=2.0 * op.K_qd)
    assert op2._aff is None
    y2 = np.asarray(op2._implicit_lhs_apply(0.5, v))
    ref = BioheatOperator(fes, rho_c=1.0, k=2.0,
                          ess_bdr=[1, 2, 3, 4, 5, 6],
                          transposed_apply=False)
    yref = np.asarray(ref._implicit_lhs_apply(0.5, v))
    assert np.abs(y2 - yref).max() <= 1e-11 * np.abs(yref).max()
    assert np.abs(y2 - y1).max() > 1e-6 * np.abs(y1).max()
