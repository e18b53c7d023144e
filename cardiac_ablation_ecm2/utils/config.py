"""Global runtime configuration.

The reference library configures itself with ~50 compile-time ``MFEM_USE_*``
macros (``config/defaults.mk:136-197``) plus a runtime ``Device::Configure``
string (``general/device.hpp:224``) and a precision switch selecting ``real_t``
(``config/defaults.mk:192-197``).  This package replaces the entire
feature matrix with this single runtime config object:

* ``dtype`` — the global scalar type ("float64" / "float32" / "bfloat16"),
  the analog of MFEM's ``real_t``.  Tests run float64 for 1e-8 parity;
  benches may select float32 with float64 reductions (see
  ``linalg.solvers``).
* quadrature defaults and scatter determinism knobs.

No compile-time flags: everything under ``jax.jit`` re-specializes as needed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_DTYPES = {
    "float64": jnp.float64,
    "float32": jnp.float32,
    "bfloat16": jnp.bfloat16,
}


@dataclasses.dataclass
class Config:
    """Global knobs. Mutate via :func:`configure` (not mid-trace)."""

    #: Global scalar type name (MFEM ``real_t`` analog).
    dtype: str = os.environ.get("CAX_DTYPE", "float64")
    #: Extra 1D quadrature points beyond the p+1 minimum: nq1d = p + 1 + quad_extra.
    quad_extra: int = 1
    #: Accumulate iterative-solver inner products in float64 even when
    #: ``dtype`` is float32 (mixed-precision CG; SURVEY.md §7 risk item 1).
    f64_reductions: bool = True
    #: ``lax.Precision`` of the float32 contractions in the sum-factorized
    #: applies.  On an NVIDIA GPU: "highest" = true f32 products (CUDA
    #: cores); "high" and "default" let cuBLAS/XLA use TF32 tensor cores,
    #: whose products keep a 10-bit mantissa (~3 decimal digits) —
    #: unacceptable for the 1e-8-parity targets.  float64 contractions are
    #: exact at every setting.
    matmul_precision: str = "highest"
    #: Lane-major transposed PA apply (ops/lanemajor.py): "auto" = on for
    #: scalar mass/diffusion/convection with nd ≤ 256 (one (nq×nd)@(nd, ne)
    #: matmul per contraction — more accurate than the staged einsums);
    #: "off" forces the sum-factorized path.
    lane_major: str = "auto"
    #: Affine separable-qdata collapse (ops/lanemajor.py): "auto" = detect
    #: W⊗d-separable qdata (straight-sided elements, constant coefficients)
    #: and apply via precomputed reference matrices — nq-fold less qdata
    #: traffic; "off" keeps the per-qpt path (bit-identical to MFEM's PA
    #: rounding — the CG-parity harness pins this, the refactored affine
    #: sum order can legitimately shift iteration counts ±1 at 1e-12).
    affine_collapse: str = "auto"


config = Config()


def configure(**kw) -> Config:
    """Update global config fields; returns the config."""
    for k, v in kw.items():
        if not hasattr(config, k):
            raise ValueError(f"unknown config field {k!r}")
        setattr(config, k, v)
    return config


#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: fixed and inside the checkout (the path is part of XLA's cache key, so a
#: moving directory never hits), and listed in ``.gitignore``.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache(path: Optional[str] = None,
                             min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache.

    The reference rebuilds nothing at run time; our analog of its
    "compile once" property is XLA's on-disk executable cache — repeat
    runs of the same jitted step skip the multi-minute compile.  Cold
    compiles are unaffected.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    no other directory is set here.  Otherwise ``path`` is used, defaulting
    to :data:`DEFAULT_CACHE_DIR`.  Returns the cache directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = path or DEFAULT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    # cache every entry point, not just top-level jits
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def real_t(dtype: Optional[object] = None):
    """Resolve the global scalar dtype (or pass through an explicit one).

    Falls back to float32 if float64 is requested without x64 enabled.
    """
    if dtype is not None:
        return jnp.dtype(dtype)
    dt = _DTYPES[config.dtype]
    if dt == jnp.float64 and not jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float32)
    return jnp.dtype(dt)


def np_real_t(dtype: Optional[object] = None):
    """Numpy view of :func:`real_t` for host-side setup code."""
    dt = real_t(dtype)
    if dt == jnp.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(dt)


def index_t():
    """Global integer index dtype for gather/scatter maps (int32)."""
    return jnp.dtype(jnp.int32)
