"""Pennes bioheat equation — the target application physics.

    ρc ∂T/∂t = ∇·(k ∇T) − ω_b c_b (T − T_a) + Q_met + Q_rf(x)

(BASELINE.json config 3; the reference's closest in-repo analogs are
``examples/ex16.cpp`` and ``miniapps/electromagnetics/joule.cpp`` — SURVEY.md
preamble.)  Discretized:

    M_ρc dT/dt = −(K_k + M_ω) T + M_ω T_a·1 + b(Q_met + Q_rf)

with essential (body-surface) temperature BCs.  ``implicit_solve`` solves
(M_ρc + γ(K_k + M_ω)) k = rhs with the stage constrained to k=0 on essential
dofs (fixed-temperature boundary), via Jacobi-PCG — all inside jit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.build import basis_for, geom_factors_for, restriction_for
from ..fem.coefficient import eval_coeff
from ..fem.fespace import FESpace
from ..fem.quadinterp import eval_values_t
from ..linalg.solvers import cg, cg_merged, default_dot
from ..ops import diffusion, lanemajor, mass
from ..utils.config import index_t, real_t


def _collapse_uniform(qd: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Collapse the element axis to size 1 when every element's qdata is
    identical to 1e-12 relative (uniform lattice, constant coefficients);
    elementwise kernels broadcast the shared slice instead of streaming
    per-element qdata from device memory."""
    ref = jax.lax.slice_in_dim(qd, 0, 1, axis=axis)
    scale = float(jnp.max(jnp.abs(ref)))
    dev = float(jnp.max(jnp.abs(qd - ref)))
    if scale > 0 and dev <= 1e-12 * scale:
        return ref
    return qd


@dataclasses.dataclass(eq=False)
class BioheatOperator:
    """TimeDependentOperator for the Pennes equation.

    Physical parameters (SI, defaults for cardiac tissue):
      rho_c   — ρ·c volumetric heat capacity [J/(m³K)]   (~3.6e6)
      k       — thermal conductivity [W/(mK)]            (~0.54)
      w_cb    — ω_b·c_b perfusion heat transfer [W/(m³K)]
      T_a     — arterial temperature [°C or K]
      q_met   — metabolic source [W/m³]
      q_rf    — RF/Joule (SAR) volumetric source, (ne, nq) Q-vector or
                coefficient
    """

    fes: FESpace
    rho_c: object = 3.6e6
    k: object = 0.54
    w_cb: object = 40000.0 * 0.0  # default: no perfusion unless set
    T_a: float = 37.0
    q_met: object = 0.0
    q_rf: object = None
    ess_bdr: Optional[Sequence[int]] = None
    rel_tol: float = 1e-10
    max_iter: int = 1000
    dtype: object = None
    #: run setup under one jit from node coords: the (ne, nq, 3, 3)
    #: Jacobian/qdata intermediates fuse away instead of being materialized
    #: eagerly.  Needs jnp-traceable coefficients.
    fused_setup: bool = False
    #: solve for θ = T − T_a instead of T.  Essential for float32: storing
    #: T ≈ 37 wastes ~7 digits on the offset (measured 0.05 K error on a
    #: 0.34 K rise over 5 steps); θ keeps full relative precision on the
    #: physically meaningful rise.  Requires boundary temperature == T_a.
    theta_form: bool = False
    #: collapse per-element qdata to one shared slice when all elements are
    #: identical (uniform lattice + constant coefficients): the CG apply
    #: then streams only the state/E-vectors instead of the 6-sym qdata —
    #: the dominant memory stream at 1M dofs.  Detected numerically (1e-12
    #: relative); elementwise broadcasting keeps every kernel unchanged.
    collapse_uniform_qdata: bool = False
    #: CG inner products: "compensated" (f32 vectors, f64 accumulation —
    #: needed for tight tolerances where the MFEM (r,z) criterion stagnates
    #: in f32; ``linalg.solvers.default_dot``), "f32" (plain — identical
    #: iteration counts at rel_tol ≥ 1e-6), or "auto" (f32 iff
    #: rel_tol ≥ 1e-6).
    dot_mode: str = "auto"
    #: store the 6-sym DIFFUSION qdata in bfloat16 (opt-in): halves the
    #: dominant memory stream of the CG apply (6 of the 8 qdata components).
    #: Contractions still accumulate in f32 (the bf16 operand upcasts);
    #: mass/perfusion qdata, diagonals and RHS stay f32 — casting the mass
    #: stream too was measured 10× worse (6.0e-4 K vs 6.0e-5 K error on a
    #: 0.66 K rise at 16³/10 steps vs the f64 reference; f32 baseline
    #: 9.7e-7 K).  See BASELINE.md.
    qdata_bf16: bool = False
    #: lane-major (nd, ne) implicit apply via the shared ops/lanemajor.py
    #: path (tensor hex/quad AND simplex bases): contractions become
    #: (nq×nd)@(nd, ne) matmuls with elements on the wide axis — more
    #: accurate than the staged einsum chain (see _implicit_lhs_apply).  Works with collapsed (broadcast) or full
    #: per-element qdata (pre-transposed once at setup).
    transposed_apply: bool = True
    #: inner CG variant: "classic" (CGSolver::Mult-shaped, two serialized
    #: reductions/iter) or "merged" (single-reduction Chronopoulos–Gear,
    #: ``linalg/solvers.cg_merged`` — identical iterates, one sync region
    #: per iteration; targets the loop-overhead half of the roofline).
    cg_variant: str = "classic"
    #: inactive-element mask (ne,) of 0/1: masked elements contribute NOTHING
    #: (qdata, RHS, diagonals).  The masked-lattice fast path: carved
    #: lattice-topology geometries (e.g. the cardiac hex mesh's electrode
    #: notch) keep the gather-free CartesianFESpace restriction — the carved
    #: region is zeroed out and its dofs pinned via ``ess_dofs``
    #: (fem/masked_lattice.py).  Equivalent to remeshing by construction:
    #: removed elements' element matrices are exactly zero.
    elem_mask: object = None
    #: explicit essential dof ids (unioned with ``ess_bdr``'s) — the
    #: masked-lattice path passes the carved-surface + inactive dofs here.
    ess_dofs: object = None
    #: "ell": apply the implicit stage operator through an ASSEMBLED
    #: bucketed multi-ELL pair (ops/ell.MultiELLPair) instead of the
    #: matrix-free PA pipeline.  The win case is simplex meshes: tet
    #: stencils are sparse (o2: ~28 nnz/row) while the PA path gathers and
    #: scatters every element's dofs.  Costs a one-time host FULL assembly
    #: at setup.  "off" = PA always.
    assembled_apply: str = "off"

    def __post_init__(self):
        fes = self.fes
        self.restr = restriction_for(fes)
        self.db = basis_for(fes, dtype=self.dtype)
        dt_ = real_t(self.dtype)

        if self.fused_setup:
            self._fused_assemble()
        else:
            self.gf = geom_factors_for(fes, dtype=self.dtype)

            rho_c_q = eval_coeff(self.rho_c, self.gf, self.dtype)
            k_q = eval_coeff(self.k, self.gf, self.dtype)
            w_q = eval_coeff(self.w_cb, self.gf, self.dtype)

            self.Mrc_qd = mass.setup(self.gf, rho_c_q)          # ρc mass
            # packed symmetric qdata: 2/3 memory traffic in the CG hot loop
            self.K_qd = diffusion.pack_sym(diffusion.setup(self.gf, k_q))
            self.Mw_qd = mass.setup(self.gf, w_q)               # perfusion

            # constant RHS: M_ω T_a 1 + (Q_met + Q_rf, v)
            src_q = eval_coeff(self.q_met, self.gf, self.dtype)
            if self.q_rf is not None:
                rf_q = eval_coeff(self.q_rf, self.gf, self.dtype)
                src_q = rf_q if src_q is None else src_q + rf_q
            q = self.Mw_qd * self.T_a
            if src_q is not None:
                q = q + self.gf.wdet * src_q
            if self.elem_mask is not None:
                m = jnp.asarray(self.elem_mask, dt_)
                self.Mrc_qd = self.Mrc_qd * m[:, None]
                self.Mw_qd = self.Mw_qd * m[:, None]
                self.K_qd = self.K_qd * m[None, :, None]
                q = q * m[:, None]
            self.b_const = self.restr.mult_transpose(
                eval_values_t(self.db, q)
            )
        self._finish_init()

    def _fused_assemble(self):
        """Jit-fused qdata/RHS/diagonal assembly from node coordinates (no
        (…,3,3) intermediates ever materialize in device memory)."""
        from ..fem.fespace import element_node_coords
        from ..fem.geom_factors import compute_geometric_factors

        fes = self.fes
        rt = real_t(self.dtype)
        X = element_node_coords(fes.mesh, fes.order)
        # transposed (sdim, ndgeo, ne) input layout: contiguous per
        # coordinate
        Xt = jnp.asarray(np.ascontiguousarray(np.transpose(X, (2, 1, 0))), rt)
        d2q = fes.d2q
        restr, db = self.restr, self.db

        @jax.jit
        def assemble(Xt):
            Xe = jnp.transpose(Xt, (2, 1, 0))          # (ne, ndgeo, sdim)
            gf = compute_geometric_factors(Xe, d2q, self.dtype)
            qm = mass.setup(gf, eval_coeff(self.rho_c, gf, self.dtype))
            qw = mass.setup(gf, eval_coeff(self.w_cb, gf, self.dtype))
            qk = diffusion.setup_packed(
                gf, eval_coeff(self.k, gf, self.dtype)
            )
            src_q = eval_coeff(self.q_met, gf, self.dtype)
            if self.q_rf is not None:
                rf_q = eval_coeff(self.q_rf, gf, self.dtype)
                src_q = rf_q if src_q is None else src_q + rf_q
            q = qw * self.T_a
            if src_q is not None:
                q = q + gf.wdet * src_q
            if self.elem_mask is not None:
                m = jnp.asarray(self.elem_mask, rt)
                qm = qm * m[:, None]
                qw = qw * m[:, None]
                qk = qk * m[None, :, None]
                q = q * m[:, None]
            b = restr.mult_transpose(eval_values_t(db, q))
            return qm, qw, qk, b

        self.Mrc_qd, self.Mw_qd, self.K_qd, self.b_const = assemble(Xt)
        self.gf = None

    def _finish_init(self):
        fes = self.fes
        # ess_bdr=None/() ⇒ pure natural BCs (unlike FESpace.essential_dofs
        # where None means "all boundary attributes")
        if self.ess_bdr:
            ess = fes.essential_dofs(self.ess_bdr)
        else:
            ess = np.zeros(0, dtype=np.int32)
        if self.ess_dofs is not None:
            ess = np.union1d(
                np.asarray(ess, np.int64),
                np.asarray(self.ess_dofs, np.int64),
            ).astype(np.int32)
        self.ess = jnp.asarray(ess, dtype=index_t())
        self.has_ess = len(ess) > 0
        # constrained-dof MASK: an elementwise multiply in every hot path
        # instead of scatters (.at[ess].set)
        mask = np.ones(fes.ndof, dtype=np.float64)
        mask[np.asarray(ess)] = 0.0
        self.ess_mask = jnp.asarray(mask, real_t(self.dtype))

        # diagonals
        restr, db = self.restr, self.db

        @jax.jit
        def diags(qm, qw, qk):
            dM = restr.mult_transpose(mass.diagonal(db, qm))
            dA = restr.mult_transpose(
                diffusion.diagonal(db, qk) + mass.diagonal(db, qw)
            )
            return dM, dA

        self.Mrc_diag, self.A_diag = diags(
            self.Mrc_qd, self.Mw_qd, self.K_qd
        )

        if self.collapse_uniform_qdata:
            self.Mrc_qd = _collapse_uniform(self.Mrc_qd, axis=0)
            self.Mw_qd = _collapse_uniform(self.Mw_qd, axis=0)
            self.K_qd = _collapse_uniform(self.K_qd, axis=1)

        # transposed (lane-major) full-matrix apply via the shared
        # ops/lanemajor.py path — see _implicit_lhs_apply.  Collapsed qdata
        # broadcasts a (nq, 1) slice; general per-element qdata is
        # pre-transposed to (nq, ne) once at setup (same total bytes,
        # lane-major stream).  Covers tensor (hex/quad) AND simplex bases.
        self._lane = None
        self._aff = None
        if self.transposed_apply and lanemajor.supports(
            self.db, self.K_qd, "diffusion"
        ):
            self._lane = lanemajor.lane_basis(self.db)
            self._qkT = lanemajor.diffusion_qT(self.K_qd)    # (3|6, nq, ne|1)
            self._qmT = self.Mrc_qd.T                        # (nq, ne|1)
            self._qwT = self.Mw_qd.T
            # affine fast path: on straight-sided meshes with per-element-
            # constant coefficients every qdata separates as W ⊗ d[e]; the
            # CG apply then streams 6·ne factors instead of 6·nq·ne qdata
            # (27× less at p2/3D — THE dominant stream on unstructured
            # meshes) and runs as one stacked reference-matrix matmul.
            # Two detectors: (1) geometric — straight-simplex meshes with
            # constant scalar coefficients are affine BY CONSTRUCTION, so
            # the factors are computed on the host in f64 from the vertices
            # (f32 qdata on sliver tets carries ~1e-3 adjugate roundoff
            # that defeats any numerical check — measured on the cardiac
            # Delaunay mesh); (2) numerical — catches lattice hexes etc.
            # Curved meshes keep the general path.
            from ..utils.config import config as _cfg

            aff_on = getattr(_cfg, "affine_collapse", "auto") != "off"
            dk = dm = dw = None
            if aff_on and all(
                not callable(c) and np.ndim(c) == 0
                for c in (self.rho_c, self.k, self.w_cb)
            ):
                from ..fem.geom_factors import (
                    affine_element_jacobians,
                    affine_packed_factors,
                )

                J = affine_element_jacobians(fes.mesh)
                if J is not None:
                    det, dkf = affine_packed_factors(J)
                    rt = real_t(self.dtype)
                    dk = jnp.asarray(float(self.k) * dkf, rt)
                    dm = jnp.asarray(float(self.rho_c) * det, rt)
                    dw = jnp.asarray(float(self.w_cb) * det, rt)
            if dk is None and aff_on:
                W = self.db.W
                dk = lanemajor.separable_collapse(self._qkT, W)
                dm = lanemajor.separable_collapse(self._qmT, W)
                dw = lanemajor.separable_collapse(self._qwT, W)
            if dk is not None and dm is not None and dw is not None:
                self._aff = lanemajor.affine_ops(self.db)
                self._dk, self._dm, self._dw = dk, dm, dw

        if self.qdata_bf16 and self._aff is None:
            self.K_qd = self.K_qd.astype(jnp.bfloat16)
            if self._lane is not None:
                self._qkT = lanemajor.diffusion_qT(self.K_qd)

        self._ell = None
        if self.assembled_apply == "ell":
            self._ell = self._build_ell_pair()

        if self.theta_form:
            # b_θ = b − A(T_a·1): constants are in K's kernel so this mostly
            # cancels the perfusion source; computed once (setup path)
            ones = jnp.ones(fes.ndof_scalar, self.b_const.dtype)
            self.b_const = self.b_const - self._A_apply(self.T_a * ones)

    def _build_ell_pair(self):
        """Assemble M_ρc and A = K + M_ω to CSR (host path) and pack them as
        a shared-pattern :class:`~..ops.ell.MultiELLPair` — the implicit
        stage operator is then one traced weight combination + weighted
        gathers per CG iteration (see ``assembled_apply``)."""
        from ..ops.bilinearform import BilinearForm
        from ..ops.ell import MultiELLPair

        fes = self.fes
        M = BilinearForm(fes).add_domain_integrator(
            "mass", self.rho_c).assemble_matrix()
        A = BilinearForm(fes).add_domain_integrator(
            "diffusion", self.k).assemble_matrix()
        if np.ndim(self.w_cb) != 0 or float(np.asarray(self.w_cb)) != 0.0:
            A = A + BilinearForm(fes).add_domain_integrator(
                "mass", self.w_cb).assemble_matrix()
        return MultiELLPair.from_csr_pair(
            M, A, dtype=str(real_t(self.dtype)))

    # ------------------------------------------------------------------
    def override(self, **kw) -> "BioheatOperator":
        """Shallow view with some fields (qdata/RHS/diagonals) replaced by
        traced values — the jit-safe analog of ex16's ``SetParameters(u)``
        rebuild (``examples/ex16.cpp:291``).  Does NOT rerun __post_init__,
        but DOES refresh the lane-path caches (``_qkT``/``_qmT``/``_qwT``)
        when their source qdata is overridden, and drops the affine collapse
        (traced qdata can't be re-checked for separability)."""
        clone = object.__new__(type(self))
        clone.__dict__ = {**self.__dict__, **kw}
        if self._lane is not None and kw.keys() & {"K_qd", "Mrc_qd", "Mw_qd"}:
            if "K_qd" in kw and "_qkT" not in kw:
                clone._qkT = lanemajor.diffusion_qT(clone.K_qd)
            if "Mrc_qd" in kw and "_qmT" not in kw:
                clone._qmT = clone.Mrc_qd.T
            if "Mw_qd" in kw and "_qwT" not in kw:
                clone._qwT = clone.Mw_qd.T
            if not (kw.keys() & {"_dk", "_dm", "_dw"}):
                clone._aff = None   # affine factors are stale
        return clone

    def _apply(self, qd_mass, qd_diff, v):
        e = self.restr.mult(v)
        out = mass.apply(self.db, qd_mass, e) + diffusion.apply(
            self.db, qd_diff, e
        )
        return self.restr.mult_transpose(out)

    def _implicit_lhs_apply(self, gamma, v):
        """(M_ρc + γ(K + M_ω)) v in ONE restriction round trip (the naive
        M-apply + A-apply pair costs an extra gather/scatter per CG
        iteration).

        Transposed path (ops/lanemajor.py): with the E-vector laid out
        (nd, ne), every contraction is a (nq×nd)@(nd, ne) matmul with the
        element axis as the wide dimension instead of contracting over
        size-3 trailing dims — ~10× lower fp error vs the f64 reference
        than the staged einsum chain (full-width HIGHEST matmuls)."""
        if self._ell is not None:
            return self._ell.mult_combined(v, 1.0, gamma)
        if self._aff is not None:
            eT = self.restr.mult_t(v)
            yT = lanemajor.affine_mass_diffusion_apply(
                self._aff, self._dm + gamma * self._dw, self._dk, eT, gamma,
            )
            return self.restr.mult_transpose_t(yT)
        if self._lane is not None:
            eT = self.restr.mult_t(v)                        # (nd, ne)
            yT = lanemajor.mass_diffusion_apply(
                self._lane, self._qmT + gamma * self._qwT, self._qkT,
                eT, gamma,
            )
            return self.restr.mult_transpose_t(yT)
        e = self.restr.mult(v)
        out = mass.apply(self.db, self.Mrc_qd + gamma * self.Mw_qd, e) \
            + gamma * diffusion.apply(self.db, self.K_qd, e)
        return self.restr.mult_transpose(out)

    def _A_apply(self, v):
        """(K_k + M_ω) v."""
        if self._ell is not None:
            return self._ell.mult1(v)
        if self._aff is not None:
            eT = self.restr.mult_t(v)
            yT = lanemajor.affine_mass_diffusion_apply(
                self._aff, self._dw, self._dk, eT,
            )
            return self.restr.mult_transpose_t(yT)
        return self._apply(self.Mw_qd, self.K_qd, v)

    def _Mrc_apply(self, v):
        if self._ell is not None:
            return self._ell.mult0(v)
        if self._aff is not None:
            eT = self.restr.mult_t(v)
            yT = lanemajor.affine_mass_apply(self._aff, self._dm, eT)
            return self.restr.mult_transpose_t(yT)
        e = self.restr.mult(v)
        return self.restr.mult_transpose(mass.apply(self.db, self.Mrc_qd, e))

    def residual(self, T):
        """RHS of M dT/dt = −A T + b."""
        return self.b_const - self._A_apply(T)

    def _dot(self):
        mode = self.dot_mode
        if mode == "auto":
            mode = "f32" if self.rel_tol >= 1e-6 else "compensated"
        if mode == "f32":
            return jnp.vdot
        return default_dot

    def _zero_ess(self, v):
        if self.has_ess:
            return v * self.ess_mask
        return v

    # -- TimeDependentOperator protocol -------------------------------
    def mult(self, t, T):
        rhs = self._zero_ess(self.residual(T))
        mask = self.ess_mask

        def Mc(v):
            z = v * mask
            # identity on the constrained subspace keeps the operator SPD
            return self._Mrc_apply(z) * mask + (v - z)

        diag = self.Mrc_diag
        if self.has_ess:
            diag = diag * mask + (1.0 - mask)
        inv = 1.0 / diag
        solve = cg_merged if self.cg_variant == "merged" else cg
        x, _ = solve(Mc, rhs, M=lambda r: inv * r, rel_tol=self.rel_tol,
                     max_iter=self.max_iter, dot=self._dot())
        return self._zero_ess(x)

    def implicit_solve(self, gamma, t, T):
        """(M_ρc + γ A) k = b − A T, with k = 0 on essential dofs."""
        rhs = self._zero_ess(self.residual(T))
        mask = self.ess_mask

        def lhs(v):
            z = v * mask
            y = self._implicit_lhs_apply(gamma, z)
            # identity on the constrained subspace keeps the operator SPD
            return y * mask + (v - z)

        diag = self.Mrc_diag + gamma * self.A_diag
        if self.has_ess:
            diag = diag * mask + (1.0 - mask)
        inv = 1.0 / diag
        solve = cg_merged if self.cg_variant == "merged" else cg
        k, _ = solve(lhs, rhs, M=lambda r: inv * r, rel_tol=self.rel_tol,
                     max_iter=self.max_iter, dot=self._dot())
        return self._zero_ess(k)


def big_arrays(op: BioheatOperator) -> dict:
    """The operator's LARGE device arrays (qdata, diagonals, RHS,
    restriction tables), keyed for :meth:`BioheatOperator.override`.

    Closed-over device arrays are inlined into the jitted step's MLIR as
    constants; at 1M elements that multi-hundred-MB compile payload slows
    compilation.  Threading them as jit ARGUMENTS keeps the module small."""
    from ..fem.restriction import ElementRestriction

    big = dict(
        b_const=op.b_const, Mrc_diag=op.Mrc_diag, A_diag=op.A_diag,
        ess_mask=op.ess_mask,
    )
    if isinstance(op.restr, ElementRestriction):
        big["restr"] = op.restr
    if getattr(op, "_ell", None) is not None:
        # assembled apply: the ELL tables + weight planes ARE the operator
        big["_ell"] = op._ell
    elif getattr(op, "_aff", None) is not None:
        # affine fast path: only the collapsed per-element factors stream
        big.update(_dm=op._dm, _dw=op._dw, _dk=op._dk)
    else:
        big.update(Mrc_qd=op.Mrc_qd, Mw_qd=op.Mw_qd, K_qd=op.K_qd)
        if getattr(op, "_lane", None) is not None:
            big.update(_qkT=op._qkT, _qmT=op._qmT, _qwT=op._qwT)
    return big


def make_stepper(op: BioheatOperator, solver) -> Callable:
    """Jitted ``(T, t, dt) -> (T', t')`` stepper with the operator's big
    arrays threaded as jit arguments (see :func:`big_arrays`)."""
    big = big_arrays(op)

    @jax.jit
    def _step(T, t, dt, big):
        return solver.step(op.override(**big), T, t, dt)

    def step(T, t, dt):
        return _step(T, t, dt, big)

    return step
