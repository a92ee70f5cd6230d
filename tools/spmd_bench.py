#!/usr/bin/env python
"""Time the shard_map chunk (parallel/spmd.py) on a row mesh of
`--devices` devices: per-substep 1-row halos or one K-row exchange per
outer step.  With one device the halos travel zero distance, so the
number is the per-shard compute of the sharded path; compare it with
tools/kernel_bench.py on the same card.

  python tools/spmd_bench.py br --flavor wide --devices 4
  python tools/spmd_bench.py court --flavor per-substep --height 1024
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import jax
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=["fenton", "br", "court", "court_ultra",
                                     "ms", "lr1", "tp06"])
    p.add_argument("--flavor", default="wide",
                   choices=["per-substep", "wide"])
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--outer", type=int, default=1000,
                   help="outer steps per timed scan")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--cheby", action="store_true", default=True)
    p.add_argument("--no-cheby", dest="cheby", action="store_false")
    p.add_argument("--skip", action="store_true", default=True)
    p.add_argument("--no-skip", dest="skip", action="store_false")
    args = p.parse_args()

    from jax.sharding import Mesh

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.models import MODEL_REGISTRY
    from fib_tf_tpu.parallel import shard_state
    from fib_tf_tpu.parallel.spmd import make_spmd_chunk
    from fib_tf_tpu.utils import cache
    from fib_tf_tpu.utils.profiling import time_fn

    cache.enable()
    # per-model recommended dt (0.1 for the reference models; the stiff
    # lr1 refuses dt > 0.05 and runs at its default 0.02)
    dt = MODEL_REGISTRY[args.model].default_dt
    cfg = SimConfig(width=args.width, height=args.height, dt=dt, duration=1,
                    diff=0.809, cheby=args.cheby, skip=args.skip,
                    ultra_slow=(args.model == "court_ultra"))
    model = MODEL_REGISTRY[args.model](cfg)
    mesh = Mesh(np.asarray(jax.devices()[:args.devices]), ("rows",))
    chunk = make_spmd_chunk(model, mesh, args.outer,
                            wide_halo=args.flavor == "wide")
    state = shard_state(model.initial_state(), mesh)
    t = time_fn(lambda s: chunk(s)[0], state, iters=args.iters, warmup=1)
    substeps = args.outer * model.dt_per_step
    print(f"{args.model} spmd[{args.flavor}] {args.devices}-device mesh "
          f"({jax.devices()[0].device_kind}) @ {args.height}x{args.width}: "
          f"{t / substeps * 1e6:.1f} us/substep ({substeps} substeps)")


if __name__ == "__main__":
    main()
