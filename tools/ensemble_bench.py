#!/usr/bin/env python
"""Ensemble throughput at small grids: members ride a vmapped leading
axis, so many small sheets fill the device the way one big sheet does —
the batching win over the reference's one-process-per-run serial S2
scans.

  python tools/ensemble_bench.py fenton --members 16 --size 128

Reports us/substep/member (each timed call ended by
`jax.block_until_ready`) and the aggregate cell-updates/s.
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
    p.add_argument("model", choices=["fenton", "br", "court", "ms", "lr1", "tp06"])
    p.add_argument("--members", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--outer", type=int, default=1000)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--mesh", action="store_true",
                   help="shard the member axis over a mesh of all "
                        "devices (members must divide the device count)")
    args = p.parse_args()

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.engine.ensemble import stack_states
    from fib_tf_tpu.models import MODEL_REGISTRY
    from fib_tf_tpu.models.base import grid_geometry
    from fib_tf_tpu.utils import cache
    from fib_tf_tpu.utils.profiling import time_fn

    cache.enable()
    dt = MODEL_REGISTRY[args.model].default_dt
    cfg = SimConfig(width=args.size, height=args.size, dt=dt, duration=1,
                    diff=1.5 if args.model == "fenton" else 0.809)
    model = MODEL_REGISTRY[args.model](cfg)
    geom = grid_geometry()
    vstep = jax.vmap(lambda s: model.step(s, geom))

    mesh = None
    if args.mesh:
        from fib_tf_tpu.parallel import make_mesh

        mesh = make_mesh()
        if args.members % mesh.devices.size:
            raise SystemExit(
                f"--members {args.members} must divide the "
                f"{mesh.devices.size}-device mesh"
            )

    @jax.jit
    def run(s):
        return jax.lax.scan(
            lambda st, _: (vstep(st), None), s, None, length=args.outer
        )[0]

    stacked = stack_states(
        [model.initial_state(s1=True)] * args.members
    )
    state = {k: jnp.asarray(v) for k, v in stacked.items()}
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        state = {k: jax.device_put(v, sh) for k, v in state.items()}
    t = time_fn(run, state, iters=args.iters, warmup=1)
    substeps = args.outer * model.dt_per_step
    us_member = t / substeps / args.members * 1e6
    cups = args.size * args.size * args.members * substeps / t / 1e9
    tag = "mesh" if mesh is not None else "one device"
    print(f"{args.model} ensemble[{tag}] x{args.members} @ {args.size}^2 "
          f"on {jax.devices()[0].device_kind}: "
          f"{us_member:.2f} us/substep/member, "
          f"{cups:.1f} G cell-updates/s ({t*1e3:.1f} ms per scan)")


if __name__ == "__main__":
    main()
