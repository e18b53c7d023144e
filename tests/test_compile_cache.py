"""Persistent XLA compilation cache (utils/config.enable_compilation_cache).

The reference's "compile once" property (ahead-of-time C++ build) maps to
XLA's on-disk executable cache: repeated runs of an unchanged jitted step
skip recompilation.  This pins the mechanism (entries are written, the
config points at the right directory), not the wall-clock.
"""

import os

import jax
import jax.numpy as jnp


def test_cache_entries_written(tmp_path, monkeypatch):
    from cardiac_ablation_ecm2.utils.config import \
        enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = str(tmp_path / "xla_cache")
    got = enable_compilation_cache(path, min_compile_secs=0.0)
    assert got == path
    assert jax.config.jax_compilation_cache_dir == path

    @jax.jit
    def f(x):
        return jnp.tanh(x @ x.T).sum()

    f(jnp.ones((64, 64))).block_until_ready()
    entries = os.listdir(path)
    assert entries, "no cache entries written"
    assert any("jit" in e for e in entries)


def test_env_var_default(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set in code;
    without it the cache lands in the fixed in-checkout default, which git
    ignores."""
    import subprocess

    from cardiac_ablation_ecm2.utils.config import (
        DEFAULT_CACHE_DIR, enable_compilation_cache)

    path = str(tmp_path / "env_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache(str(tmp_path / "other")) == path
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.path.exists(tmp_path / "other")

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    default = DEFAULT_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(default) == repo
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(default, "entry")],
        cwd=repo).returncode
    assert ignored in (0, 128)      # 128: not a git checkout (e.g. archive)
    try:
        assert enable_compilation_cache() == default
        assert jax.config.jax_compilation_cache_dir == default
        assert os.path.isdir(default)
    finally:
        # later tests in this worker must not fill the checkout's cache
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_enable_compilation_cache", False)
