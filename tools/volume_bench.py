#!/usr/bin/env python
"""Volume (3D) microbenchmark: µs per substep of one outer step over a
[D, H, W] volume, each timed call ended by `jax.block_until_ready`.

  python tools/volume_bench.py fenton --depth 16 --height 256 --width 512
  python tools/volume_bench.py br --depth 8 --height 256 --width 512

`--mesh1` runs the wide-halo shard_map chunk on a 1-device mesh
(zero-distance halos: the per-shard compute of the z-sharded path).
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=["fenton", "br", "court", "court_ultra",
                                     "ms", "lr1"])
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--dz-ratio", type=float, default=1.0)
    p.add_argument("--twist", type=float, default=0.0,
                   help="fiber_twist radians (enables rotational anisotropy)")
    p.add_argument("--fiber-ratio", type=float, default=1.0)
    p.add_argument("--outer", type=int, default=200)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--mesh1", action="store_true",
                   help="run the wide-halo shard_map chunk on a 1-device "
                        "mesh (zero-distance halos; measures the "
                        "per-shard compute of the sharded path)")
    p.add_argument("--halo-k", type=int, default=None,
                   help="wide-halo exchange cadence (see run_volume)")
    args = p.parse_args()

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.models import MODEL_REGISTRY
    from fib_tf_tpu.models.base import volume_geometry
    from fib_tf_tpu.engine.volume import volume_state
    from fib_tf_tpu.ops import stencil3d
    from fib_tf_tpu.utils import cache
    from fib_tf_tpu.utils.profiling import time_fn

    cache.enable()
    # respect the model's stability bound (the stiff lr1 runs at 0.02)
    dt = min(args.dt, MODEL_REGISTRY[args.model].default_dt)
    cfg = SimConfig(width=args.width, height=args.height, dt=dt,
                    duration=1, diff=0.809,
                    ultra_slow=(args.model == "court_ultra"))
    model = MODEL_REGISTRY[args.model](cfg)
    fiber = None
    if args.fiber_ratio < 1.0:
        angles = stencil3d.twist_angles(args.depth, 0.0, args.twist)
        fiber = stencil3d.fiber_tensors(angles, args.fiber_ratio)
    geom = volume_geometry(dz_ratio=args.dz_ratio, fiber=fiber)

    state_mb = (len(model.state_keys()) * args.depth * args.height
                * args.width * 4 / 2 ** 20)
    state = {k: jnp.asarray(v)
             for k, v in volume_state(model, args.depth).items()}

    if args.mesh1:
        from jax.sharding import Mesh
        from fib_tf_tpu.parallel.volume_spmd import make_volume_spmd_chunk

        mesh = Mesh(np.array(jax.devices()[:1]), ("z",))

        chunk = make_volume_spmd_chunk(
            model, mesh, args.outer, args.depth, dz_ratio=args.dz_ratio,
            fiber=fiber, halo_k=args.halo_k,
        )
        buf = jnp.zeros((), jnp.float32)

        def scan(s):
            return chunk(s, buf, jnp.int32(0))[0]
    else:
        @jax.jit
        def scan(s):
            return jax.lax.scan(
                lambda st, _: (model.step(st, geom), None), s, None,
                length=args.outer)[0]

    print(f"state {state_mb:.1f} MB", flush=True)
    t = time_fn(scan, state, iters=args.iters, warmup=1)
    substeps = args.outer * model.dt_per_step
    us = t / substeps * 1e6
    cells = args.depth * args.height * args.width
    gcup = cells / us * 1e-3
    tag = "mesh1" if args.mesh1 else "one device"
    print(f"{args.model} {tag} ({jax.devices()[0].device_kind}) @ "
          f"{args.depth}x{args.height}x{args.width}: {us:.1f} us/substep "
          f"({gcup:.1f} G cell-updates/s, {substeps} substeps)")


if __name__ == "__main__":
    main()
