#!/usr/bin/env python
"""Quantify the engine's overhead over the bare step: µs/substep of the
bare `model.step` scan, the scan with the engine's per-step probe
emission, and the full `Simulation.simulate` path, each timed call ended
by `jax.block_until_ready`.

  python tools/engine_gap_bench.py br
  python tools/engine_gap_bench.py fenton
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp


def timed_scan(body, state, outer, iters=5):
    """Seconds per outer step of scanning `body` (median of `iters`)."""
    from fib_tf_tpu.utils.profiling import time_fn

    scan = jax.jit(lambda s: jax.lax.scan(body, s, None, length=outer))
    return time_fn(scan, state, iters=iters, warmup=1) / outer


def main():
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=["fenton", "br"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--outer", type=int, default=200)
    args = p.parse_args()

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.models import MODEL_REGISTRY, grid_geometry
    from fib_tf_tpu.utils import cache

    cache.enable()
    cfg = SimConfig(width=args.size, height=args.size, dt=0.1, duration=1,
                    diff=0.809, cheby=True, skip=True)
    model = MODEL_REGISTRY[args.model](cfg)
    geom = grid_geometry()

    def kstep(s):
        return model.step(s, geom)

    state = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
    sub = model.dt_per_step

    # A: bare step scan (what tools/kernel_bench.py reports)
    a = timed_scan(lambda s, _: (kstep(s), None), state, args.outer)
    print(f"A bare step scan:            {a / sub * 1e6:7.2f} us/substep")

    # B: + the engine's per-step probe emission (XLA-side pixel read)
    sim = Simulation(model).define()

    def body_probe(s, _):
        s = kstep(s)
        return s, sim._probes(s)

    b = timed_scan(body_probe, state, args.outer)
    print(f"B + per-step probe emit:     {b / sub * 1e6:7.2f} us/substep")

    # C: probe only every plot_interval (reference cadence, ionic.py:206-216)
    pi = cfg.plot_interval(model.dt_per_step)

    def body_strided(s, _):
        for _i in range(pi):
            s = kstep(s)
        return s, sim._probes(s)

    c = timed_scan(body_strided, state, max(1, args.outer // pi))
    print(f"C probe every {pi} outer:       {c / (sub * pi) * 1e6:7.2f} us/substep")

    # D: the full engine, chunked at the default probe cadence
    cfg_d = cfg.replace(duration=5000.0)
    sim_d = Simulation(MODEL_REGISTRY[args.model](cfg_d)).define()
    sim_d.simulate(check_finite=False)
    res = sim_d.simulate(check_finite=False)
    d = res.elapsed / (res.steps * sub)
    print(f"D full simulate():           {d * 1e6:7.2f} us/substep "
          f"({res.steps} outer steps, {res.elapsed*1e3:.0f} ms)")


if __name__ == "__main__":
    main()
