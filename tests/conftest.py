"""Test harness configuration.

Mirrors the reference's testing split (SURVEY.md §4): serial unit tests plus
"parallel" tests that in MFEM run under ``mpirun -np N``.  Here the analog is
a virtual 8-device CPU mesh (``--xla_force_host_platform_device_count=8``),
and x64 is enabled so correctness tests hit the 1e-8 parity bar (BASELINE.md).

The suite itself runs on the CPU backend (``jax_platforms`` is forced to
"cpu" below).  Tests that need a GPU carry the ``gpu`` marker, decide inside
the test body whether a card is present (skipping without one), and run
their GPU work in a child process; on a machine with a card run them with
``python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (inside the test) without one")
