"""Mixed-pairing bilinear integrators across H1 / ND / RT / L2 spaces.

Reference analog: the mixed H1–ND–RT integrator family of
``fem/bilininteg.hpp:784-2121`` — ``MixedScalarMassIntegrator``,
``MixedVectorGradientIntegrator`` (:1787), ``MixedVectorCurlIntegrator``
(:1862), ``MixedScalarCurlIntegrator``, ``VectorFEDivergenceIntegrator``
(:2121), ``MixedVectorWeakDivergenceIntegrator`` (:1830),
``VectorFEMassIntegrator`` with distinct trial/test spaces — as used by
ex24 and the joule miniapp's coupled EM formulations.

Design: one generic rectangular PA operator.  Every pairing is

    y = Rₛᵀ Bₛᵀ  diag(qd)  Bₜ Rₜ x

with Bₜ/Bₛ per-space *physical* basis tables (Piola/covariant pullbacks
already applied, shared quadrature rule) and one batched einsum chain —
no per-pairing kernels.  Orientation handling (±1 signs or true
DofTransformations) rides the same pre/post closures as the square
``VecFEOperator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..fem.build import geom_factors_for
from ..fem.fe_vector import NDSpace, RTSpace
from ..utils.config import index_t, real_t


def _kind(space) -> str:
    k = getattr(space, "kind", None)
    if k is not None:
        return k
    if isinstance(space, NDSpace):
        return "nd"
    if isinstance(space, RTSpace):
        return "rt"
    raise TypeError(f"not a vector FE space: {space!r}")


def _wrap(space, rt):
    """(gather, pre, post, ndof) for any supported space."""
    if hasattr(space, "transform"):                       # VectorSimplexSpace
        return (jnp.asarray(space.gather_map, index_t()),
                space.transform, space.transform_t, space.ndof)
    if hasattr(space, "signs"):                           # NDSpace/RTSpace/HO
        sg = jnp.asarray(space.signs, rt)

        def pre(e):
            return e * sg

        return (jnp.asarray(space.gather_map, index_t()),
                pre, pre, space.ndof)
    # scalar H1 / L2 space
    gm = jnp.asarray(space.gather_map, index_t())

    def ident(e):
        return e

    return gm, ident, ident, space.ndof_scalar


def _vec_tables(space, nq1d, dtype):
    """(gf, value_table, deriv_table) for an ND/RT space.

    value: (ne, nq, ndl, dim) physical vector basis.  deriv: curl for ND
    ((ne, nq, ndl, 3) in 3D, (ne, nq, ndl) scalar in 2D), div for RT
    ((ne, nq, ndl)).  Reuses the audited square-operator table builders.
    """
    from .vecfe import build_nd_operator, build_rt_operator

    if _kind(space) == "nd":
        op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                               nq1d=nq1d, dtype=dtype)
        val = next(B for n, _, B in op.terms if n == "mass")
        der = next(B for n, _, B in op.terms if n == "curlcurl")
        if space.mesh.dim == 2:
            der = der[..., 0] if der.ndim == 4 else der
    else:
        op = build_rt_operator(space, mass_coeff=1.0, divdiv_coeff=1.0,
                               nq1d=nq1d, dtype=dtype)
        val = next(B for n, _, B in op.terms if n == "mass")
        der = next(B for n, _, B in op.terms if n == "divdiv")[..., 0]
    return op.gf, val, der


def _scalar_value(fes, nq1d, rt):
    """Shared value table (nq, nd) for an H1/L2 space at the nq1d rule."""
    return jnp.asarray(fes.dof_to_quad(nq1d).full_B(), rt)


def _scalar_grad(fes, gf, nq1d, rt):
    """Physical gradient table (ne, nq, nd, dim): J⁻ᵀ∇̂ = adjᵀ∇̂/det."""
    from ..fem.geom_factors import adjugate

    G = jnp.asarray(fes.dof_to_quad(nq1d).full_G(), rt)
    A = adjugate(gf.jac)
    return jnp.einsum("eqab,qna->eqnb", A / gf.det[..., None, None], G)


@dataclasses.dataclass(eq=False)
class MixedVecFEOperator:
    """Rectangular PA operator  y = Rₛᵀ Bₛᵀ diag(qd) Bₜ Rₜ x."""

    g_trial: jnp.ndarray
    g_test: jnp.ndarray
    pre_trial: Callable
    post_trial: Callable
    pre_test: Callable
    post_test: Callable
    Bt: jnp.ndarray               # (ne|1?, nq, n_trial[, c])
    Bs: jnp.ndarray               # test table, same channel shape
    qd: jnp.ndarray               # (ne, nq) weights (coeff · w · detJ ...)
    ndof_trial: int
    ndof_test: int

    def _eval(self, B, e):
        if B.ndim == 4:
            return jnp.einsum("eqnc,en->eqc", B, e)
        if B.ndim == 2:                                  # shared (nq, nd)
            return jnp.einsum("qn,en->eq", B, e)[..., None]
        if B.ndim == 3:                                  # (ne, nq, nd)
            return jnp.einsum("eqn,en->eq", B, e)[..., None]
        raise ValueError(B.shape)

    def _evalT(self, B, q):
        if B.ndim == 4:
            return jnp.einsum("eqnc,eqc->en", B, q)
        if B.ndim == 2:
            return jnp.einsum("qn,eq->en", B, q[..., 0])
        if B.ndim == 3:
            return jnp.einsum("eqn,eq->en", B, q[..., 0])
        raise ValueError(B.shape)

    def _couple(self, qe, transpose=False):
        """qdata coupling: scalar (ne, nq) or matrix (ne, nq, cs, ct)."""
        if self.qd.ndim == 4:
            eq = "eqst,eqs->eqt" if transpose else "eqst,eqt->eqs"
            return jnp.einsum(eq, self.qd, qe)
        return qe * self.qd[..., None]

    def mult(self, x: jnp.ndarray) -> jnp.ndarray:
        e = self.pre_trial(x[self.g_trial])
        q = self._couple(self._eval(self.Bt, e))
        y = self.post_test(self._evalT(self.Bs, q))
        out = jnp.zeros(self.ndof_test, dtype=y.dtype)
        return out.at[self.g_test.reshape(-1)].add(y.reshape(-1))

    def mult_t(self, y: jnp.ndarray) -> jnp.ndarray:
        e = self.pre_test(y[self.g_test])
        q = self._couple(self._eval(self.Bs, e), transpose=True)
        x = self.post_trial(self._evalT(self.Bt, q))
        out = jnp.zeros(self.ndof_trial, dtype=x.dtype)
        return out.at[self.g_trial.reshape(-1)].add(x.reshape(-1))

    def assemble_matrix(self):
        """scipy CSR (ndof_test, ndof_trial) — tests / FULL fallback."""
        import scipy.sparse as sp

        ne = self.qd.shape[0]
        nt = self.g_trial.shape[1]
        ns = self.g_test.shape[1]
        cols_e = np.zeros((ne, ns, nt))
        eye = jnp.eye(nt, dtype=self.qd.dtype)
        for j in range(nt):
            e = self.pre_trial(jnp.broadcast_to(eye[j], (ne, nt)))
            q = self._couple(self._eval(self.Bt, e))
            cols_e[:, :, j] = np.asarray(
                self.post_test(self._evalT(self.Bs, q)))
        rows = np.broadcast_to(
            np.asarray(self.g_test)[:, :, None], cols_e.shape).reshape(-1)
        cols = np.broadcast_to(
            np.asarray(self.g_trial)[:, None, :], cols_e.shape).reshape(-1)
        return sp.csr_matrix(
            (cols_e.reshape(-1), (rows, cols)),
            shape=(self.ndof_test, self.ndof_trial))


def _make(trial, test, Bt, Bs, gf, coeff, rt):
    gt, pre_t, post_t, nt = _wrap(trial, rt)
    gs, pre_s, post_s, ns = _wrap(test, rt)
    return MixedVecFEOperator(
        g_trial=gt, g_test=gs,
        pre_trial=pre_t, post_trial=post_t,
        pre_test=pre_s, post_test=post_s,
        Bt=Bt, Bs=Bs, qd=coeff * gf.wdet,
        ndof_trial=nt, ndof_test=ns)


def mixed_vector_gradient(h1_fes, nd_space, coeff=1.0, nq1d=3, dtype=None,
                          matrix_coeff=None):
    """(σ∇u, v): H1 trial → ND test (MixedVectorGradientIntegrator,
    fem/bilininteg.hpp:1787).  ``matrix_coeff`` — optional (d×d) matrix σ
    (constant array or callable of x) applied to the trial gradient."""
    rt = real_t(dtype)
    gf, Bnd, _ = _vec_tables(nd_space, nq1d, dtype)
    Gh1 = _scalar_grad(h1_fes, gf, nq1d, rt)
    if matrix_coeff is not None:
        if callable(matrix_coeff):
            sig = jnp.asarray(matrix_coeff(gf.x), rt)
        else:
            sig = jnp.broadcast_to(
                jnp.asarray(matrix_coeff, rt),
                gf.det.shape + np.asarray(matrix_coeff).shape)
        Gh1 = jnp.einsum("eqcd,eqnd->eqnc", sig, Gh1)
    return _make(h1_fes, nd_space, Gh1, Bnd, gf, coeff, rt)


def mixed_vector_weak_divergence(nd_space, h1_fes, coeff=1.0, nq1d=3,
                                 dtype=None):
    """−(u, ∇v): ND trial → H1 test (MixedVectorWeakDivergenceIntegrator,
    fem/bilininteg.hpp:1830) — the negative transpose of
    ``mixed_vector_gradient``."""
    rt = real_t(dtype)
    gf, Bnd, _ = _vec_tables(nd_space, nq1d, dtype)
    Gh1 = _scalar_grad(h1_fes, gf, nq1d, rt)
    return _make(nd_space, h1_fes, Bnd, Gh1, gf, -coeff, rt)


def mixed_vector_mass(trial_space, test_space, coeff=1.0, nq1d=3,
                      dtype=None):
    """(u, v) with distinct trial/test vector spaces (ND×RT or RT×ND;
    VectorFEMassIntegrator mixed form, fem/bilininteg.hpp:2704)."""
    rt = real_t(dtype)
    gf, Bt, _ = _vec_tables(trial_space, nq1d, dtype)
    _, Bs, _ = _vec_tables(test_space, nq1d, dtype)
    return _make(trial_space, test_space, Bt, Bs, gf, coeff, rt)


def mixed_vector_curl(nd_space, rt_space, coeff=1.0, nq1d=3, dtype=None):
    """(curl u, v): ND trial → RT test, 3D (MixedVectorCurlIntegrator,
    fem/bilininteg.hpp:1862)."""
    assert nd_space.mesh.dim == 3
    rt = real_t(dtype)
    gf, _, Cnd = _vec_tables(nd_space, nq1d, dtype)
    _, Brt, _ = _vec_tables(rt_space, nq1d, dtype)
    return _make(nd_space, rt_space, Cnd, Brt, gf, coeff, rt)


def mixed_weak_curl(rt_space, nd_space, coeff=1.0, nq1d=3, dtype=None):
    """(u, curl v): RT trial → ND test, 3D (MixedVectorWeakCurlIntegrator,
    fem/bilininteg.hpp:1936) — the weak curl used by joule's WeakCurl."""
    assert nd_space.mesh.dim == 3
    rt = real_t(dtype)
    gf, Brt, _ = _vec_tables(rt_space, nq1d, dtype)
    _, _, Cnd = _vec_tables(nd_space, nq1d, dtype)
    return _make(rt_space, nd_space, Brt, Cnd, gf, coeff, rt)


def mixed_scalar_curl(nd_space, l2_fes, coeff=1.0, nq1d=3, dtype=None):
    """(curl u, q): ND trial → L2 test, 2D scalar curl
    (MixedScalarCurlIntegrator, fem/bilininteg.hpp:1053)."""
    assert nd_space.mesh.dim == 2
    rt = real_t(dtype)
    gf, _, Cnd = _vec_tables(nd_space, nq1d, dtype)
    Bl2 = _scalar_value(l2_fes, nq1d, rt)
    return _make(nd_space, l2_fes, Cnd[..., None], Bl2, gf, coeff, rt)


def vectorfe_divergence(rt_space, l2_fes, coeff=1.0, nq1d=3, dtype=None):
    """(div u, q): RT trial → L2 test, any order
    (VectorFEDivergenceIntegrator, fem/bilininteg.hpp:2121; generalizes the
    RT0×P0 ``ops.block.mixed_divergence``)."""
    rt = real_t(dtype)
    gf, _, Drt = _vec_tables(rt_space, nq1d, dtype)
    Bl2 = _scalar_value(l2_fes, nq1d, rt)
    return _make(rt_space, l2_fes, Drt[..., None], Bl2, gf, coeff, rt)


def mixed_scalar_mass(trial_fes, test_fes, coeff=1.0, nq1d=3, dtype=None):
    """(u, q) across distinct scalar spaces, e.g. H1×L2
    (MixedScalarMassIntegrator, fem/bilininteg.hpp:817)."""
    rt = real_t(dtype)
    from ..fem.basis import make_dof_to_quad
    from ..fem.fespace import element_node_coords
    from ..fem.geom_factors import compute_geometric_factors

    mesh = trial_fes.mesh
    d2q = make_dof_to_quad(mesh.geom, 1, nq1d)
    gf = compute_geometric_factors(
        element_node_coords(mesh, 1), d2q, dtype=dtype)
    Bt = _scalar_value(trial_fes, nq1d, rt)
    Bs = _scalar_value(test_fes, nq1d, rt)
    return _make(trial_fes, test_fes, Bt, Bs, gf, coeff, rt)


def _ident(e):
    return e


def vector_divergence(vfes, pfes, coeff=1.0, nq1d=None, dtype=None):
    """(c div u, q): vector-H1 trial (byNODES layout) → scalar H1/L2 test
    (VectorDivergenceIntegrator, fem/bilininteg.hpp:3028) — the Stokes /
    Taylor–Hood pressure block.  The two spaces may have different orders;
    both tables are built at the same ``nq1d`` rule on the same mesh."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, dtype)
    Gphys = _scalar_grad(vfes, gf, nq1d, rt)     # (ne, nq, nd, dim)
    vdim = vfes.vdim
    ns_v = vfes.ndof_scalar
    gm_v = np.asarray(vfes.gather_map)
    g_trial = np.concatenate([gm_v + c * ns_v for c in range(vdim)], axis=1)
    Bt = jnp.concatenate([Gphys[..., c] for c in range(vdim)],
                         axis=2)[..., None]      # (ne, nq, nd·vdim, 1)
    Bs = _scalar_value(pfes, nq1d, rt)           # (nq, nd_p)
    cq = jnp.asarray(coeff(gf.x), rt) if callable(coeff) else float(coeff)
    return MixedVecFEOperator(
        g_trial=jnp.asarray(g_trial, index_t()),
        g_test=jnp.asarray(pfes.gather_map, index_t()),
        pre_trial=_ident, post_trial=_ident,
        pre_test=_ident, post_test=_ident,
        Bt=Bt, Bs=Bs, qd=cq * gf.wdet,
        ndof_trial=vfes.ndof, ndof_test=pfes.ndof_scalar)


def gradient(pfes, vfes, coeff=1.0, nq1d=None, dtype=None):
    """(c ∇p, v): scalar H1 trial → vector-H1 test (GradientIntegrator,
    fem/bilininteg.hpp:2284; GradientIntegrator::AssembleElementMatrix2 in
    bilininteg.cpp).  The derivative lands on the TRIAL (scalar) space —
    this is NOT the transpose of :func:`vector_divergence`, which by
    integration by parts differs by a sign and a boundary-mass term
    (advisor finding, round 3).  For the divergence transpose (the Stokes
    pressure-gradient block −Dᵀ) use ``vector_divergence(...).mult_t``."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, dtype)
    Gp = _scalar_grad(pfes, gf, nq1d, rt)        # (ne, nq, nd_p, dim)
    d = vfes.vdim
    cq = jnp.asarray(coeff(gf.x), rt) if callable(coeff) else \
        jnp.asarray(float(coeff), rt)
    QD = cq[..., None, None] * jnp.eye(d, dtype=rt)   # (…, d, d) identity
    QD = jnp.broadcast_to(QD, gf.det.shape + (d, d))
    return _coupled((pfes.gather_map, Gp),
                    _h1_vec_value(vfes, nq1d, rt),
                    QD, gf, pfes.ndof_scalar, vfes.ndof)


def derivative(fes_trial, fes_test, direction: int, coeff=1.0, nq1d=None,
               dtype=None):
    """(c ∂u/∂x_i, v) on scalar spaces (DerivativeIntegrator,
    fem/bilininteg.hpp:2204)."""
    rt = real_t(dtype)
    nq1d = nq1d or (fes_trial.order + 2)
    gf = geom_factors_for(fes_trial, nq1d, dtype)
    Gphys = _scalar_grad(fes_trial, gf, nq1d, rt)
    Bt = Gphys[..., direction][..., None]        # (ne, nq, nd, 1)
    Bs = _scalar_value(fes_test, nq1d, rt)
    cq = jnp.asarray(coeff(gf.x), rt) if callable(coeff) else float(coeff)
    return MixedVecFEOperator(
        g_trial=jnp.asarray(fes_trial.gather_map, index_t()),
        g_test=jnp.asarray(fes_test.gather_map, index_t()),
        pre_trial=_ident, post_trial=_ident,
        pre_test=_ident, post_test=_ident,
        Bt=Bt, Bs=Bs, qd=cq * gf.wdet,
        ndof_trial=fes_trial.ndof_scalar, ndof_test=fes_test.ndof_scalar)


# ----------------------------------------------------------------------------
# the cross/dot/directional pairing family (fem/bilininteg.hpp:1034 ff.)
# ----------------------------------------------------------------------------

def _h1_vec_value(vfes, nq1d, rt):
    """(g_trial, table) for a vdim H1 space as a vector field: block
    value table B[q, n + c·nd, c'] = φ_n(q) δ_cc' with byNODES gathers."""
    Bsc = np.asarray(_scalar_value(vfes, nq1d, rt))     # (nq, nd)
    nq, nd = Bsc.shape
    d = vfes.vdim
    tab = np.zeros((nq, nd * d, d))
    for c in range(d):
        tab[:, c * nd:(c + 1) * nd, c] = Bsc
    gm = np.asarray(vfes.gather_map)
    g = np.concatenate([gm + c * vfes.ndof_scalar for c in range(d)],
                       axis=1)
    return g, jnp.asarray(tab, rt)


def _vq(V, gf, rt, dim):
    """Vector coefficient at quadrature points → (ne, nq, dim)."""
    if callable(V):
        return jnp.asarray(V(gf.x), rt)
    arr = jnp.asarray(V, rt)
    ne, nq = gf.det.shape
    return jnp.broadcast_to(arr[None, None, :], (ne, nq, dim))


def _coupled(trial_pack, test_pack, QD, gf, nt, ns):
    gt, Bt = trial_pack
    gs, Bs = test_pack
    if isinstance(Bt, np.ndarray):
        Bt = jnp.asarray(Bt)
    if isinstance(Bs, np.ndarray):
        Bs = jnp.asarray(Bs)
    # shared (nq, nd, c) tables broadcast across elements for the 4-dim path
    ne = gf.det.shape[0]
    if Bt.ndim == 3 and Bt.shape[0] == gf.det.shape[1]:
        Bt = jnp.broadcast_to(Bt[None], (ne,) + Bt.shape)
    if Bs.ndim == 3 and Bs.shape[0] == gf.det.shape[1]:
        Bs = jnp.broadcast_to(Bs[None], (ne,) + Bs.shape)
    return MixedVecFEOperator(
        g_trial=jnp.asarray(np.asarray(gt), index_t()),
        g_test=jnp.asarray(np.asarray(gs), index_t()),
        pre_trial=_ident, post_trial=_ident,
        pre_test=_ident, post_test=_ident,
        Bt=Bt, Bs=Bs, qd=QD * gf.wdet[..., None, None],
        ndof_trial=nt, ndof_test=ns)


def _sc_pack(sfes, nq1d, rt):
    """Scalar space as a 1-channel table (nq, nd, 1)."""
    B = _scalar_value(sfes, nq1d, rt)
    return sfes.gather_map, B[..., None]


def mixed_dot_product(vfes, sfes, V, nq1d=None, dtype=None):
    """(V·u, q): vector-H1 trial → scalar test
    (MixedDotProductIntegrator, fem/bilininteg.hpp)."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, dtype)
    d = vfes.vdim
    Vq = _vq(V, gf, rt, d)
    QD = Vq[:, :, None, :]                            # (ne, nq, 1, d)
    return _coupled(_h1_vec_value(vfes, nq1d, rt),
                    _sc_pack(sfes, nq1d, rt),
                    QD, gf, vfes.ndof, sfes.ndof_scalar)


def mixed_vector_product(sfes, vfes, V, nq1d=None, dtype=None):
    """(V u, w): scalar trial → vector-H1 test
    (MixedVectorProductIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, dtype)
    d = vfes.vdim
    Vq = _vq(V, gf, rt, d)
    QD = Vq[:, :, :, None]                            # (ne, nq, d, 1)
    return _coupled(_sc_pack(sfes, nq1d, rt),
                    _h1_vec_value(vfes, nq1d, rt),
                    QD, gf, sfes.ndof_scalar, vfes.ndof)


def _skew3(Vq):
    """(ne, nq, 3) → (ne, nq, 3, 3) with S u = V × u."""
    z = jnp.zeros_like(Vq[..., 0])
    vx, vy, vz = Vq[..., 0], Vq[..., 1], Vq[..., 2]
    return jnp.stack([
        jnp.stack([z, -vz, vy], axis=-1),
        jnp.stack([vz, z, -vx], axis=-1),
        jnp.stack([-vy, vx, z], axis=-1),
    ], axis=-2)


def mixed_cross_product(vfes_t, vfes_s, V, nq1d=None, dtype=None):
    """(V × u, w): 3D vector-H1 trial and test
    (MixedCrossProductIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes_t.order + 2)
    gf = geom_factors_for(vfes_t, nq1d, dtype)
    Vq = _vq(V, gf, rt, 3)
    return _coupled(_h1_vec_value(vfes_t, nq1d, rt),
                    _h1_vec_value(vfes_s, nq1d, rt),
                    _skew3(Vq), gf, vfes_t.ndof, vfes_s.ndof)


def mixed_scalar_cross_product(vfes, sfes, V, nq1d=None, dtype=None):
    """(V × u, q) in 2D — V×u = V_x u_y − V_y u_x
    (MixedScalarCrossProductIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (vfes.order + 2)
    gf = geom_factors_for(vfes, nq1d, dtype)
    Vq = _vq(V, gf, rt, 2)
    QD = jnp.stack([-Vq[..., 1], Vq[..., 0]], axis=-1)[:, :, None, :]
    return _coupled(_h1_vec_value(vfes, nq1d, rt),
                    _sc_pack(sfes, nq1d, rt),
                    QD, gf, vfes.ndof, sfes.ndof_scalar)


def mixed_directional_derivative(h1_fes, sfes, V, nq1d=None, dtype=None):
    """(V·∇u, q): H1 trial → scalar test
    (MixedDirectionalDerivativeIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, dtype)
    d = h1_fes.mesh.dim
    Gphys = _scalar_grad(h1_fes, gf, nq1d, rt)        # (ne, nq, nd, d)
    Vq = _vq(V, gf, rt, d)
    return _coupled((h1_fes.gather_map, Gphys),
                    _sc_pack(sfes, nq1d, rt),
                    Vq[:, :, None, :], gf,
                    h1_fes.ndof_scalar, sfes.ndof_scalar)


def mixed_grad_grad(trial_fes, test_fes, coeff=1.0, nq1d=None, dtype=None):
    """(λ ∇u, ∇v) across two (possibly different-order) H1 spaces
    (MixedGradGradIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (max(trial_fes.order, test_fes.order) + 2)
    gf = geom_factors_for(trial_fes, nq1d, dtype)
    d = trial_fes.mesh.dim
    Gt = _scalar_grad(trial_fes, gf, nq1d, rt)
    Gs = _scalar_grad(test_fes, gf, nq1d, rt)
    ne, nq = gf.det.shape
    eye = jnp.eye(d, dtype=rt)
    if callable(coeff):
        QD = jnp.asarray(coeff(gf.x), rt)[..., None, None] * eye
    else:
        QD = float(coeff) * jnp.broadcast_to(eye, (ne, nq, d, d))
    return _coupled((trial_fes.gather_map, Gt),
                    (test_fes.gather_map, Gs), QD, gf,
                    trial_fes.ndof_scalar, test_fes.ndof_scalar)


def mixed_cross_grad_grad(trial_fes, test_fes, V, nq1d=None, dtype=None):
    """(V × ∇u, ∇v) on 3D H1 spaces (MixedCrossGradGradIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (max(trial_fes.order, test_fes.order) + 2)
    gf = geom_factors_for(trial_fes, nq1d, dtype)
    Gt = _scalar_grad(trial_fes, gf, nq1d, rt)
    Gs = _scalar_grad(test_fes, gf, nq1d, rt)
    Vq = _vq(V, gf, rt, 3)
    return _coupled((trial_fes.gather_map, Gt),
                    (test_fes.gather_map, Gs), _skew3(Vq), gf,
                    trial_fes.ndof_scalar, test_fes.ndof_scalar)


def _coupled_w(trial_pack, test_pack, QD, gf):
    """Like ``_coupled`` but with (gather, table, pre, post, ndof) packs —
    needed when a side is an ND/RT space with orientation signs."""
    gt, Bt, pre_t, post_t, nt = trial_pack
    gs, Bs, pre_s, post_s, ns = test_pack
    ne, nq = gf.det.shape
    # shared (nq, nd, c) tables broadcast across elements (3-dim means
    # (ne, nq, nd) to the eval paths)
    if Bt.ndim == 3 and Bt.shape[0] == nq:
        Bt = jnp.broadcast_to(jnp.asarray(Bt)[None], (ne,) + Bt.shape)
    if Bs.ndim == 3 and Bs.shape[0] == nq:
        Bs = jnp.broadcast_to(jnp.asarray(Bs)[None], (ne,) + Bs.shape)
    return MixedVecFEOperator(
        g_trial=jnp.asarray(np.asarray(gt), index_t()),
        g_test=jnp.asarray(np.asarray(gs), index_t()),
        pre_trial=pre_t, post_trial=post_t,
        pre_test=pre_s, post_test=post_s,
        Bt=Bt, Bs=Bs, qd=QD * gf.wdet[..., None, None],
        ndof_trial=nt, ndof_test=ns)


def _nd_packs(space, nq1d, dtype, rt):
    """(gf, value_pack, curl_pack) for an ND space with sign/transform
    wraps included."""
    gf, val, der = _vec_tables(space, nq1d, dtype)
    g, pre, post, nd = _wrap(space, rt)
    return gf, (g, val, pre, post, nd), (g, der, pre, post, nd)


def mixed_cross_curl(nd_space, vfes, V, nq1d=3, dtype=None):
    """(V × curl u, w): 3D ND trial → vector-H1 test
    (MixedCrossCurlIntegrator, fem/bilininteg.hpp)."""
    rt = real_t(dtype)
    gf, _valp, curlp = _nd_packs(nd_space, nq1d, dtype, rt)
    Vq = _vq(V, gf, rt, 3)
    gs, Bs = _h1_vec_value(vfes, nq1d, rt)
    return _coupled_w(curlp,
                      (gs, Bs, _ident, _ident, vfes.ndof),
                      _skew3(Vq), gf)


def mixed_cross_grad(h1_fes, vfes, V, nq1d=None, dtype=None):
    """(V × ∇u, w): 3D H1 trial → vector-H1 test
    (MixedCrossGradIntegrator)."""
    rt = real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, dtype)
    Gt = _scalar_grad(h1_fes, gf, nq1d, rt)
    Vq = _vq(V, gf, rt, 3)
    gs, Bs = _h1_vec_value(vfes, nq1d, rt)
    return _coupled_w((h1_fes.gather_map, Gt, _ident, _ident,
                       h1_fes.ndof_scalar),
                      (gs, Bs, _ident, _ident, vfes.ndof),
                      _skew3(Vq), gf)


def mixed_scalar_weak_divergence(sfes, h1_fes, V, nq1d=None, dtype=None):
    """−(V u, ∇w): scalar trial → H1 test
    (MixedScalarWeakDivergenceIntegrator) — the weak form of
    (div(V u), w) for interior test functions."""
    rt = real_t(dtype)
    nq1d = nq1d or (h1_fes.order + 2)
    gf = geom_factors_for(h1_fes, nq1d, dtype)
    d = h1_fes.mesh.dim
    Gs = _scalar_grad(h1_fes, gf, nq1d, rt)
    Vq = _vq(V, gf, rt, d)
    Bt = _scalar_value(sfes, nq1d, rt)[..., None]
    return _coupled_w((sfes.gather_map, Bt, _ident, _ident,
                       sfes.ndof_scalar),
                      (h1_fes.gather_map, Gs, _ident, _ident,
                       h1_fes.ndof_scalar),
                      -Vq[:, :, :, None], gf)
