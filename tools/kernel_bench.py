#!/usr/bin/env python
"""What XLA makes of the plain step: µs per substep, device kernels per
substep, and HBM traffic per substep against the card's bandwidth.

One outer step of `model.step` runs as a jitted scan on the default
device; each timed call ends in `jax.block_until_ready`.  With `--trace
DIR` a second, short scan runs under `jax.profiler` and the device
kernels launched in it are counted from the trace.

  python tools/kernel_bench.py br --size 512
  python tools/kernel_bench.py br --size 4096 --outer 20
  python tools/kernel_bench.py fenton --size 512 --trace chiprun_out/tr

HBM bytes per substep are computed from shapes: every state plane read
and written once (planes x cells x 4 B x 2), the traffic of a step that
fuses each substep into one pass.  The share is those bytes over the
measured time, divided by the card's published bandwidth
(`PEAK_HBM_BYTES_PER_S`; a card not in the table gets no share).
"""

import argparse
import glob
import json
import os as _os
import subprocess
import sys as _sys
import time

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

# Published HBM bandwidth by jax `device_kind` (NVIDIA H100 SXM data sheet)
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def count_device_kernels(trace_dir: str):
    """(events, busy_ns, lines) of the first GPU plane in the newest
    trace under `trace_dir`: kernel events on its stream lines, the
    union of their intervals, and a per-line summary for reading the
    trace by hand."""
    path = sorted(glob.glob(_os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines, spans = [], []
        for line in plane.lines:
            evs = list(line.events)
            lines.append((line.name, len(evs),
                          sum(e.duration_ns for e in evs)))
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.end_ns) for e in evs]
        busy, end = 0.0, -np.inf
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        return len(spans), busy, lines
    raise RuntimeError(f"no GPU plane in {path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("model",
                   choices=["fenton", "br", "court", "court_ultra", "ms",
                            "lr1", "tp06"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--outer", type=int, default=200,
                   help="outer steps per timed scan")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--cheby", action="store_true", default=True)
    p.add_argument("--no-cheby", dest="cheby", action="store_false")
    p.add_argument("--skip", action="store_true", default=True)
    p.add_argument("--no-skip", dest="skip", action="store_false")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also trace a short scan and count its kernels")
    p.add_argument("--trace-outer", type=int, default=10)
    args = p.parse_args()

    from fib_tf_tpu.cli import _default_diff
    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.models import MODEL_REGISTRY
    from fib_tf_tpu.models.base import grid_geometry
    from fib_tf_tpu.utils import cache
    from fib_tf_tpu.utils.profiling import time_fn

    cache.enable()
    dev = jax.devices()[0]
    cls = MODEL_REGISTRY[args.model]
    cfg = SimConfig(width=args.size, height=args.size, dt=cls.default_dt,
                    duration=1, diff=_default_diff(args.model),
                    cheby=args.cheby, skip=args.skip,
                    ultra_slow=(args.model == "court_ultra"))
    model = cls(cfg)
    geom = grid_geometry()
    state = {k: jnp.asarray(v) for k, v in model.initial_state().items()}

    def make_scan(n):
        @jax.jit
        def scan(s):
            return jax.lax.scan(lambda st, _: (model.step(st, geom), None),
                                s, None, length=n)[0]
        return scan

    scan = make_scan(args.outer)
    t0 = time.perf_counter()
    jax.block_until_ready(scan(state))
    setup_s = time.perf_counter() - t0
    t = time_fn(scan, state, iters=args.iters, warmup=1)
    substeps = args.outer * model.dt_per_step
    us = t / substeps * 1e6
    n_planes = len(model.state_keys())
    bytes_per_substep = n_planes * args.size * args.size * 4 * 2
    peak = PEAK_HBM_BYTES_PER_S.get(dev.device_kind)
    rec = {
        "model": args.model, "size": args.size,
        "cheby": args.cheby, "skip": args.skip,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "us_per_substep": us, "setup_s": setup_s,
        "substeps_timed": substeps, "planes": n_planes,
        "hbm_bytes_per_substep": bytes_per_substep,
        "hbm_share": (bytes_per_substep / (us * 1e-6) / peak
                      if peak else None),
    }
    if args.trace:
        tscan = make_scan(args.trace_outer)
        jax.block_until_ready(tscan(state))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(tscan(state))
        n_ev, busy_ns, lines = count_device_kernels(args.trace)
        tsub = args.trace_outer * model.dt_per_step
        rec["kernels_per_substep"] = n_ev / tsub
        rec["trace_busy_us_per_substep"] = busy_ns / 1e3 / tsub
        for name, n, dur in lines:
            print(f"  trace line {name!r}: {n} events, {dur / 1e3:.1f} us",
                  flush=True)
    if dev.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
