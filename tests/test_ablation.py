"""Coupled RF ablation app (BASELINE configs 3-4): potential → SAR → bioheat →
Arrhenius lesion, with an analytic cross-check on the uniform-field case."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.models import ablation, rf_laplace


def test_rf_uniform_field():
    """Plate-electrode box: Φ is linear in z, SAR = σ(V/L)² exactly."""
    L, V, sigma = 0.02, 20.0, 0.5
    mesh = make_cartesian_3d(3, 3, 3, L, L, L)
    res = rf_laplace.solve(
        mesh, order=2, sigma=sigma, electrode_bdr=[6], ground_bdr=[1],
        voltage=V,
    )
    assert res.converged
    E = V / L
    sar_exact = sigma * E * E
    assert np.allclose(np.asarray(res.sar_q), sar_exact, rtol=1e-8)
    P = float(rf_laplace.total_power(res.fes, res.sar_q))
    assert np.isclose(P, sar_exact * L**3, rtol=1e-10)


def test_ablation_heating_and_lesion():
    """2cm tissue cube, plate electrodes: T rises, lesion volume is monotone
    and bounded by the domain."""
    L = 0.02
    mesh = make_cartesian_3d(4, 4, 4, L, L, L)
    sim = ablation.AblationSim(
        mesh=mesh, order=2, sigma=0.5, voltage=50.0,
        electrode_bdr=[6], ground_bdr=[1],
        w_cb=20000.0, body_bdr=None, solver="sdirk33", rel_tol=1e-11,
    )
    T, om = sim.initial_state()
    t = 0.0
    assert float(jnp.max(om)) == 0.0
    vols = []
    for _ in range(8):
        T, om, t = sim.step(T, om, t, 0.5)
        vols.append(sim.lesion_volume(om))
    Tmax = float(jnp.max(T))
    assert Tmax > 37.5, Tmax            # heating happened
    assert Tmax < 150.0, Tmax           # physically plausible
    assert all(b >= a for a, b in zip(vols, vols[1:]))   # lesion monotone
    assert vols[-1] <= L**3 + 1e-12
    # energy balance sanity: with uniform SAR, mean temperature rise over the
    # first step ≈ Q dt/ρc (before conduction/perfusion losses dominate)
    E = 50.0 / L
    q = 0.5 * E * E
    rise_ub = q * 4.0 / 3.6e6          # upper bound on mean rise after 4 s
    mean_rise = float(jnp.mean(T)) - 37.0
    assert 0 < mean_rise <= rise_ub * 1.05, (mean_rise, rise_ub)


def test_coupled_sigma_T_resolve_changes_heating():
    """σ(T) rising with temperature (≈+1.5%/°C) and a potential re-solve
    every 2 steps must deliver more power into heated tissue than the
    one-shot constant-σ solve (joule.cpp-style feedback loop)."""
    L = 0.02
    mesh = make_cartesian_3d(4, 4, 4, L, L, L)
    kw = dict(
        mesh=mesh, order=2, sigma=0.5, voltage=60.0,
        electrode_bdr=[6], ground_bdr=[1],
        w_cb=0.0, body_bdr=None, solver="sdirk33", rel_tol=1e-11,
    )
    base = ablation.AblationSim(**kw)
    Tb, omb, _ = base.run(4.0, 0.5)

    sim = ablation.AblationSim(
        **kw, sigma_T=lambda Tq: 0.5 * (1.0 + 0.015 * (Tq - 37.0)),
        resolve_every=2,
    )
    Tc, omc, _ = sim.run(4.0, 0.5)

    rise_b = float(jnp.mean(Tb)) - 37.0
    rise_c = float(jnp.mean(Tc)) - 37.0
    assert rise_b > 0.5
    # feedback: hotter tissue conducts better -> more Joule power -> hotter.
    # With plate electrodes the field is ~uniform, so the effect tracks the
    # mean σ rise; it must be clearly measurable and physically modest.
    assert rise_c > rise_b * 1.005, (rise_b, rise_c)
    assert rise_c < rise_b * 1.5
    # damage integral responds too
    assert float(jnp.max(omc)) >= float(jnp.max(omb))


def test_coupled_k_T_changes_profile():
    """k(T) rising with temperature flattens the hot spot: peak T drops
    vs constant k, mean stays (energy input unchanged)."""
    import numpy as onp

    L = 0.02
    mesh = make_cartesian_3d(4, 4, 4, L, L, L)

    # localized heating via a needle-like electrode patch: use attribute 6
    # (top) as electrode and 1 (bottom) as ground but fix body temperature
    # on the grounded face so conduction matters.
    kw = dict(
        mesh=mesh, order=2, sigma=0.5, voltage=60.0,
        electrode_bdr=[6], ground_bdr=[1],
        w_cb=0.0, body_bdr=[1], solver="sdirk33", rel_tol=1e-11,
    )
    base = ablation.AblationSim(**kw)
    Tb, _, _ = base.run(4.0, 0.5)

    sim = ablation.AblationSim(
        **kw, k_T=lambda Tq: 0.54 * (1.0 + 0.02 * (Tq - 37.0)),
    )
    Tc, _, _ = sim.run(4.0, 0.5)

    # enhanced conduction pulls heat to the fixed-T boundary: peak drops
    assert float(jnp.max(Tc)) < float(jnp.max(Tb)), (
        float(jnp.max(Tc)), float(jnp.max(Tb)))
    # and the fields genuinely differ
    assert not onp.allclose(onp.asarray(Tc), onp.asarray(Tb))
