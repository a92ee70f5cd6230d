#!/usr/bin/env python
"""Pseudo-electrogram over a 1024x512 fibrillating Beeler-Reuter sheet,
the grid sharded over every device.

Spatial domain decomposition: the [1024, 512] grid is row-sharded over a
device mesh.  The default is explicit shard_map with wide (K-row) halos:
one K-row ppermute pair per OUTER step between neighbouring devices.
Electrode means are masked psums.  `--narrow` selects the per-substep
1-row exchange path and `--gspmd` the XLA-inferred-collectives path,
both kept as cross-checks.

Without several devices, run on a virtual CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/egm_sharded.py --duration 20
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.engine.observers import ElectrogramRecorder
from fib_tf_tpu.models import BeelerReuter
from fib_tf_tpu.parallel import make_mesh


def main():
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=3000.0)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=512)
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--narrow", action="store_true",
                      help="per-substep 1-row halo exchange instead of "
                           "the wide-halo default")
    path.add_argument("--gspmd", action="store_true",
                      help="GSPMD path (XLA infers the halo collectives) "
                           "instead of explicit shard_map")
    args = ap.parse_args()

    n_dev = len(jax.devices())
    cfg = SimConfig(
        width=args.width, height=args.height, dt=0.1, dt_per_plot=10,
        diff=1.0, duration=args.duration, cheby=True, skip=False,
    )
    model = BeelerReuter(cfg)
    mesh = make_mesh()

    if args.gspmd:
        from fib_tf_tpu.parallel import plane_sharding

        sim = Simulation(model, sharding=plane_sharding(mesh))
    elif args.narrow:
        sim = Simulation(model, mesh=mesh)
    else:
        # the default: one K-row halo exchange per outer step
        sim = Simulation(model, mesh=mesh, wide_halo=True)
    sim.add_hole_to_phase_field(150, args.height // 2, 50)
    sim.add_electrode(300 + 15, args.height // 2, radius=5)
    sim.add_electrode(300 - 15, args.height // 2, radius=5)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)

    res = sim.simulate(schedule=[(300, "s2")])
    print(f"{n_dev} devices, {args.height}x{args.width}: "
          f"{res.elapsed:.2f} s ({res.cell_updates_per_sec/1e9:.2f} G "
          f"cell-updates/s, {res.sim_seconds_per_wall_second:.2f}x real "
          f"time)")

    rec = ElectrogramRecorder(every_ms=1.0, dt=cfg.dt,
                              dt_per_step=model.dt_per_step)
    rec.feed(0, res.probes["egm"])
    rec.save("egm_sharded.dat")
    print(f"saved {rec.as_array().shape[0]} electrogram samples")


if __name__ == "__main__":
    main()
