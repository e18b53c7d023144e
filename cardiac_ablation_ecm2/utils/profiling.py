"""Profiling helpers (reference analogs: ``StopWatch`` timers plus the
``MFEM_PERF_*`` annotation macros in ``general/annotation.hpp`` — here the
device-side story is ``jax.profiler`` with named scopes that show up in the
TensorBoard/Perfetto trace viewer).

Usage::

    from cardiac_ablation_ecm2.utils.profiling import trace, scope

    with trace("/tmp/tb"):          # captures a device trace
        with scope("bioheat-step"):
            u = step(u)
    # or annotate inside jitted code:
    @jax.jit
    def f(x):
        with scope("diffusion-apply"):
            return apply(db, qd, x)
"""

from __future__ import annotations

import contextlib
import logging
import os

import jax


def scope(name: str):
    """Named scope: labels ops in profiler traces (works under jit)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace to ``logdir`` (TensorBoard 'profile' plugin /
    Perfetto).  No-op-safe: falls back to a bare context if the profiler is
    unavailable on the backend."""
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:   # pragma: no cover - backend without profiler
        started = False
    try:
        yield
    finally:
        if started:
            jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Host-side trace annotation (StepTraceAnnotation analog)."""
    try:
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:   # pragma: no cover
        yield


class KernelReporter:
    """Compile-cache reporter (``fem/kernel_reporter.hpp`` analog).

    The reference's KernelReporter warns the first time a *fallback* kernel
    runs (a specialization miss).  Under XLA the equivalent perf hazard is a
    *retrace*: the same jitted function compiling again for a new
    shape/dtype signature — silent, and each occurrence costs seconds of
    compile plus cache growth.  This reporter hooks JAX's compile logging
    and counts compiles per function, flagging multi-signature functions.

    Enable with ``KernelReporter.enable()`` or the environment variable
    ``ECM2_REPORT_KERNELS`` (mirroring ``MFEM_REPORT_KERNELS``)::

        KernelReporter.enable()
        ... run ...
        KernelReporter.report()       # prints per-kernel compile counts
        stats = KernelReporter.summary()   # {name: [signature, ...]}
    """

    _handler = None
    _compiles: dict = {}

    class _Handler(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if not msg.startswith("Compiling "):
                return
            # "Compiling jit(name) with global shapes and types (sig)..."
            head, _, rest = msg[len("Compiling "):].partition(
                " with global shapes and types ")
            sig = rest.split(". Argument mapping")[0].strip()
            KernelReporter._compiles.setdefault(head, []).append(sig)

    @classmethod
    def enable(cls) -> None:
        if cls._handler is not None:
            return
        jax.config.update("jax_log_compiles", True)
        cls._handler = cls._Handler(level=logging.WARNING)
        logger = logging.getLogger("jax._src.interpreters.pxla")
        logger.addHandler(cls._handler)
        if logger.level > logging.WARNING or logger.level == 0:
            logger.setLevel(logging.WARNING)

    @classmethod
    def disable(cls) -> None:
        if cls._handler is None:
            return
        jax.config.update("jax_log_compiles", False)
        logging.getLogger("jax._src.interpreters.pxla").removeHandler(
            cls._handler)
        cls._handler = None

    @classmethod
    def reset(cls) -> None:
        cls._compiles = {}

    @classmethod
    def summary(cls) -> dict:
        return {k: list(v) for k, v in cls._compiles.items()}

    @classmethod
    def retraced(cls) -> dict:
        """Functions compiled for more than one distinct signature."""
        return {k: v for k, v in cls._compiles.items()
                if len(set(v)) > 1}

    @classmethod
    def report(cls, stream=None) -> None:
        import sys

        out = stream or sys.stderr
        for name, sigs in sorted(cls._compiles.items()):
            uniq = len(set(sigs))
            flag = "  ** RETRACED **" if uniq > 1 else ""
            print(f"{name}: {len(sigs)} compiles, {uniq} signatures{flag}",
                  file=out)


if os.environ.get("ECM2_REPORT_KERNELS", "NO").upper() not in ("", "NO", "0"):
    KernelReporter.enable()
