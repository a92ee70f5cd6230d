"""Profiling and observability helpers.

Reference equivalents (SURVEY.md §5): the Chrome-trace timeline of one step
(ionic.py:231-241) maps to `jax.profiler` traces viewable in
Perfetto/XProf; the TensorBoard graph dump (`save_graph`,
ionic.py:190-191) maps to HLO text dumps; the wall-clock print
(ionic.py:243) maps to `Timer`/`throughput`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace (Perfetto/XProf), the timeline analog."""
    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        yield
    print(f"profiler trace written to {logdir}")


def dump_hlo(fn: Callable, args, path: str, optimized: bool = False):
    """Write the (optionally compiler-optimized) HLO of jit(fn)(*args)."""
    lowered = jax.jit(fn).lower(*args)
    text = (
        lowered.compile().as_text() if optimized else lowered.as_text()
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def time_fn(fn: Callable, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall seconds of fn(*args), each call ended by
    `jax.block_until_ready` on its result."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def throughput(
    height: int, width: int, substeps: int, elapsed: float, dt_ms: float
) -> Dict[str, float]:
    """The framework's standard performance report."""
    cups = height * width * substeps / max(elapsed, 1e-12)
    sim_s = substeps * dt_ms / 1000.0
    return {
        "elapsed_s": elapsed,
        "cell_updates_per_sec": cups,
        "wall_s_per_sim_s": elapsed / max(sim_s, 1e-12),
        "realtime_factor": sim_s / max(elapsed, 1e-12),
    }
