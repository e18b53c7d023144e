"""ex16-class heat conduction and Pennes bioheat tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import l2_error, l2_norm, project
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_2d, make_cartesian_3d
from cardiac_ablation_ecm2.models import bioheat, heat


def test_linear_heat_manufactured():
    """κ const (α=0): T = e^{-2π²κt} sin(πx)sin(πy); SDIRK33 should track it."""
    mesh = make_cartesian_2d(12, 12)
    fes = FESpace(mesh, 2)
    kappa = 0.5
    op = heat.ConductionOperator(fes, kappa=kappa, alpha=0.0,
                                 ess_bdr=[1, 2, 3, 4], rel_tol=1e-12)
    solver = ode.select("sdirk33")
    step = heat.make_stepper(op, solver)

    def u0(x):
        x = np.asarray(x)
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])

    u = project(fes, u0)
    t, dt, tf = 0.0, 0.005, 0.05
    while t < tf - 1e-12:
        u, t = step(u, t, dt)
    decay = np.exp(-2 * np.pi**2 * kappa * float(t))

    def u_exact(x):
        return decay * u0(x)

    err = float(l2_error(fes, u, u_exact))
    assert err < 2e-4, err


def test_nonlinear_heat_energy_decay():
    """ex16 proper: κ(u) = κ + αu; no forcing ⇒ interior energy decays
    monotonically (homogeneous Neumann conserves mean, decays norm)."""
    mesh = make_cartesian_2d(8, 8)
    fes = FESpace(mesh, 2)
    op = heat.ConductionOperator(fes, kappa=0.5, alpha=0.2, rel_tol=1e-12)
    step = heat.make_stepper(op, ode.select("sdirk23"))

    def u0(x):
        x = np.asarray(x)
        return np.exp(-20 * ((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2))

    u = project(fes, u0)
    norms = [float(l2_norm(fes, u))]
    t, dt = 0.0, 0.01
    for _ in range(5):
        u, t = step(u, t, dt)
        norms.append(float(l2_norm(fes, u)))
    assert all(n2 < n1 + 1e-12 for n1, n2 in zip(norms, norms[1:])), norms


def test_explicit_implicit_agree():
    """RK4 with small dt ≈ SDIRK33 with same dt on smooth data."""
    mesh = make_cartesian_2d(6, 6)
    fes = FESpace(mesh, 1)
    op = heat.ConductionOperator(fes, kappa=0.2, alpha=0.1, rel_tol=1e-13)

    def u0(x):
        x = np.asarray(x)
        return np.cos(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])

    u_i = project(fes, u0)
    u_e = u_i
    step_i = heat.make_stepper(op, ode.select("sdirk33"))
    step_e = heat.make_stepper(op, ode.select("rk4"))
    t = 0.0
    for _ in range(10):
        u_i, _ = step_i(u_i, t, 1e-3)
        u_e, _ = step_e(u_e, t, 1e-3)
        t += 1e-3
    assert float(l2_norm(fes, u_i - u_e)) < 5e-5


def test_bioheat_equilibrium():
    """With strong perfusion and no source, T relaxes to T_a everywhere."""
    mesh = make_cartesian_2d(6, 6, 0.04, 0.04)   # 4cm square
    fes = FESpace(mesh, 2)
    op = bioheat.BioheatOperator(
        fes=fes, rho_c=3.6e6, k=0.54, w_cb=2e5, T_a=37.0,
        ess_bdr=None, rel_tol=1e-12,
    )
    step = bioheat.make_stepper(op, ode.select("sdirk33"))
    T = jnp.full(fes.ndof, 42.0)
    t = 0.0
    for _ in range(40):
        T, t = step(T, t, 5.0)
    assert np.allclose(np.asarray(T), 37.0, atol=1e-3), (
        float(np.abs(np.asarray(T) - 37).max())
    )


def test_bioheat_steady_state_with_source():
    """Uniform source + Dirichlet walls: steady state solves
    −kΔT + ωc(T−Ta) = Q; compare implicit time-march to direct solve."""
    mesh = make_cartesian_2d(8, 8, 0.02, 0.02)
    fes = FESpace(mesh, 2)
    Q = 5e5
    op = bioheat.BioheatOperator(
        fes=fes, rho_c=3.6e6, k=0.54, w_cb=4e4, T_a=37.0, q_met=Q,
        ess_bdr=[1, 2, 3, 4], rel_tol=1e-12,
    )
    step = bioheat.make_stepper(op, ode.select("backward_euler"))
    T = jnp.full(fes.ndof, 37.0)
    t = 0.0
    for _ in range(60):
        T, t = step(T, t, 20.0)
    # steady state: residual(T) ≈ 0 on free dofs
    r = np.asarray(op._zero_ess(op.residual(T)))
    scale = np.abs(np.asarray(op.b_const)).max()
    assert np.abs(r).max() < 1e-6 * scale, np.abs(r).max()
    assert float(jnp.max(T)) > 37.5   # heated interior


def test_bioheat_bf16_qdata_accuracy():
    """Opt-in bf16 diffusion qdata (models/bioheat.py qdata_bf16): operator
    stream halves, end-to-end temperature error stays ~1e-4-K-level on a
    0.66 K rise (measured 6.0e-5 K vs the f64 reference at 16^3; casting
    the mass qdata too was 10x worse and is deliberately NOT done)."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.models.bioheat import BioheatOperator

    L = 0.04
    mesh = make_cartesian_3d(8, 8, 8, L, L, L)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 1e6 * jnp.exp(-r2 / (L / 8) ** 2)

    def run(bf):
        fes = FESpace(mesh, 2)
        op = BioheatOperator(fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
                             q_met=src, ess_bdr=[1, 2, 3, 4, 5, 6],
                             rel_tol=1e-8, theta_form=True, qdata_bf16=bf)
        solver = ode.select("sdirk33")
        T = jnp.zeros(fes.ndof)
        t, dt = jnp.asarray(0.0), jnp.asarray(0.25)
        for _ in range(5):
            T, t = solver.step(op, T, t, dt)
        return float(T.max())

    ref, bf16 = run(False), run(True)
    assert ref > 0.1                      # heating happened
    assert abs(bf16 - ref) < 3e-4 * max(ref, 1.0)


def test_bioheat_merged_cg_matches_classic():
    """cg_variant='merged' (single-reduction Chronopoulos-Gear) produces
    the same trajectory as the classic CG loop."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.linalg import ode
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d
    from cardiac_ablation_ecm2.models import bioheat

    mesh = make_cartesian_3d(6, 6, 6, 0.04, 0.04, 0.04)
    from cardiac_ablation_ecm2.fem import FESpace

    fes = FESpace(mesh, 2)

    def src(x):
        r2 = sum((x[..., i] - 0.02) ** 2 for i in range(3))
        return 1e6 * jnp.exp(-r2 / 0.005**2)

    kw = dict(fes=fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0,
              q_met=src, ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-10,
              max_iter=400, dtype="float64", theta_form=True)
    solver = ode.select("sdirk33")
    Ts = {}
    for variant in ("classic", "merged"):
        op = bioheat.BioheatOperator(cg_variant=variant, **kw)
        T = jnp.zeros(fes.ndof, dtype=jnp.float64)
        t, dt = jnp.asarray(0.0), jnp.asarray(0.25)
        for _ in range(3):
            T, t = solver.step(op, T, t, dt)
        Ts[variant] = T
    diff = float(jnp.abs(Ts["classic"] - Ts["merged"]).max())
    scale = float(jnp.abs(Ts["classic"]).max())
    assert scale > 0.01            # something actually heated up
    assert diff < 1e-9 * scale, (diff, scale)
