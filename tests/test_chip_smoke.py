"""chip_smoke.py and bench.py: they refuse to run without a GPU, and
chip_smoke's phases pass their own checks at tiny sizes on the CPU against
the host scipy float64 reference (the GPU run uses the same code at full
size).  The ``gpu`` test runs small phases on a card in a child process."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    p = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       cwd=REPO, env=_cpu_env(), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def _assert_ok(out, ck, names):
    assert ck.ok, ck.items
    got = {c["name"] for c in ck.items}
    for n in names:
        assert any(n in g for g in got), (n, got)
    assert np.isfinite(out["theta_max"]) and out["theta_max"] > 0


def test_phase_lattice_small():
    out, ck = _smoke().phase_lattice(n=4, n_ref=3)
    _assert_ok(out, ck, ["f32 vs f64", "f32 field vs host f64",
                         "f64 field vs host f64"])
    assert out["ndof"] == 9 ** 3 and out["ref_ndof"] == 7 ** 3


def test_phase_cardiac_tet_and_ell_small():
    sm = _smoke()
    ctx = {}
    out, ck = sm.phase_cardiac_tet(ctx, n=6)
    _assert_ok(out, ck, ["f32 field vs host f64", "f64 field vs host f64"])
    out, ck = sm.phase_cardiac_tet_ell(ctx)
    _assert_ok(out, ck, ["f64 field vs PA f64",
                         "vs scipy f64"])


def test_phase_ablation_small():
    out, ck = _smoke().phase_ablation(n=4)
    _assert_ok(out, ck, ["lesion volume > 0", "lesion volume f32 vs f64"])


def test_phase_four_cards_on_virtual_devices():
    out, ck = _smoke().phase_four_cards(n=6, ndev=4)
    _assert_ok(out, ck, ["one shard on each device",
                         "sharded field vs one card"])
    assert out["ndev"] == 4


def test_host_reference_matches_exact_ode_in_time():
    """The host SDIRK33 reference is third order: halving DT on a
    mass-only (k=0, w=0) problem reproduces θ = t·M⁻¹F."""
    sm = _smoke()
    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.mesh import make_cartesian_3d

    fes = FESpace(make_cartesian_3d(2, 2, 2, sm.L, sm.L, sm.L), 1)
    M, K, Mw = sm.host_matrices(fes)
    Z = 0.0 * K
    theta = sm.host_reference(fes, sm.LATTICE_SRC, [], mats=(M, Z, Z))
    F = sm.host_load(fes, sm.LATTICE_SRC)
    import scipy.sparse.linalg as spla

    exact = sm.NSTEPS * sm.DT * spla.spsolve(M.tocsc(), F)
    np.testing.assert_allclose(theta, exact, rtol=1e-10)


@pytest.mark.gpu
def test_chip_smoke_small_phases_on_gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True
                                     ).returncode != 0:
        pytest.skip("no GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax, chip_smoke as s;"
        "jax.config.update('jax_enable_x64', True);"
        "assert jax.devices()[0].platform == 'gpu';"
        "ctx = {};"
        "r = [s.phase_lattice(n=8, n_ref=4), s.phase_cardiac_tet(ctx, n=8),"
        " s.phase_cardiac_tet_ell(ctx), s.phase_ablation(n=6)];"
        "bad = [o['phase'] for o, c in r if not c.ok];"
        "assert not bad, bad")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
