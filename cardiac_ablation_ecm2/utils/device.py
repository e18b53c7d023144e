"""The accelerator a measurement runs on.

Every timing this package prints names its device, and a measurement path
that finds no GPU stops instead of timing the CPU backend.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX's default backend is not a GPU."""


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices, as JAX reports
    them (``jax.devices()[0].platform``, ``.device_kind``, device count).

    Raises :class:`NoGPUError` when the default backend is not a GPU.
    """
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default backend is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this measurement runs only on a GPU")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each (a card set below its maximum power runs slower under load, so the
    limit is printed beside every number).  Runs in a child process that
    does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
