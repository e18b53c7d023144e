"""Wall-clock timing utilities (reference: ``StopWatch``, general/tic_toc.hpp:35).

On an accelerator, async dispatch means a timer must block on the result; callers pass the
arrays to :meth:`StopWatch.stop` so we can ``block_until_ready`` first.
"""

from __future__ import annotations

import time

import jax


class StopWatch:
    def __init__(self):
        self._t0 = 0.0
        self._acc = 0.0
        self._running = False

    def start(self):
        self._t0 = time.perf_counter()
        self._running = True
        return self

    def stop(self, *block_on):
        for x in block_on:
            jax.block_until_ready(x)
        if self._running:
            self._acc += time.perf_counter() - self._t0
            self._running = False
        return self._acc

    def clear(self):
        self._acc = 0.0
        self._running = False

    @property
    def seconds(self) -> float:
        return self._acc
