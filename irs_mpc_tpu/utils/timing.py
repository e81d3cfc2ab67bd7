"""Structured timing + profiling.

The reference's only instrumentation is wall-clock prints inside ``iterate``
(``irs_lqr/irs_lqr.py:200-203``) and commented-out cProfile harnesses
(``run_planar_hand.py:191-194``).  This module provides labelled phase
timers with aggregate stats and a jax.profiler trace context for device
timeline capture (SURVEY §5.1 "build: structured per-phase timers +
jax.profiler traces").
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax


class PhaseTimer:
    """Accumulates wall-time per labelled phase.

    Usage::
        timer = PhaseTimer()
        with timer.phase("estimate"):
            ...
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} total {t * 1e3:10.2f} ms   "
                         f"calls {c:5d}   mean {t / c * 1e3:8.3f} ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/irs_mpc_tpu_trace"):
    """Capture a jax.profiler trace (TensorBoard-compatible) around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
