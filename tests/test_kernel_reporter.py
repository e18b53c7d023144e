"""KernelReporter analog (fem/kernel_reporter.hpp): compile-cache /
retrace reporting via JAX's compile logging."""

import io

import jax
import jax.numpy as jnp

from cardiac_ablation_ecm2.utils.profiling import KernelReporter


def test_kernel_reporter_flags_retraces():
    KernelReporter.enable()
    KernelReporter.reset()

    @jax.jit
    def reported_step(x):
        return x * 2 + 1

    reported_step(jnp.ones(4))
    reported_step(jnp.ones(4))            # cache hit: no new compile
    reported_step(jnp.ones(8))            # retrace: new shape signature
    try:
        s = KernelReporter.summary()
        assert "jit(reported_step)" in s
        assert len(s["jit(reported_step)"]) == 2
        assert "jit(reported_step)" in KernelReporter.retraced()
        buf = io.StringIO()
        KernelReporter.report(buf)
        assert "RETRACED" in buf.getvalue()
    finally:
        KernelReporter.disable()
    # disabled: no further records
    KernelReporter.reset()
    reported_step(jnp.ones(16))
    assert KernelReporter.summary() == {}
