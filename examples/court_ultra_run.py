#!/usr/bin/env python
"""Courtemanche-ultra fibrillation protocol: small-domain induction, state
save, large-domain restart.

Reference court_ultra.py:489-559: run a small annulus domain to induce
fibrillation, log phase-weighted means + fibrillation density rho every
500 ms, save the state; then restart on a larger domain seeded from the
saved state.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


from functools import partial

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.engine.observers import fibrillation_density
from fib_tf_tpu.models import CourtemancheUltra
from fib_tf_tpu.utils import checkpoint


def cl_observer(sim, cyclelengths, i0, i, cl):
    """Log cycle length + phase-weighted means of Na/Ca and the ultra-slow
    machinery (court_ultra.py:465-486).  The means are computed ON-DEVICE
    inside the compiled scan and ride the per-step probe stream, so every
    mid-run log line reports the LIVE state at step i — exactly like the
    reference's .eval() reads at each cycle-length event."""
    mean_na, mean_ca, mean_us, mean_us_inf, mean_tau_us = (
        sim.probe_at_step(i, "ultra")
    )
    cyclelengths.append([i0 + i, cl, mean_na, mean_ca])
    print("%d:\t%d\t%.3f\t%.3f\tus=%.3f us_inf=%.3f tau_us=%.0f"
          % (i + i0, cl, mean_na, mean_ca, mean_us, mean_us_inf,
             mean_tau_us))


def run_small(cfg, cyclelengths, radius=50, i0=0):
    sim = Simulation(CourtemancheUltra(cfg))
    sim.add_hole_to_phase_field(cfg.width // 2, cfg.height // 2, radius)
    sim.add_hole_to_phase_field(
        cfg.width // 2, cfg.height // 2, cfg.width // 2 - 6, neg=True
    )
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    sim.cl_observer = partial(cl_observer, sim, cyclelengths, i0)

    res = sim.simulate(schedule=[(min(300, cfg.duration * 0.3), "s2")])
    img = (res.state["V"] - sim.model.min_v) / (
        sim.model.max_v - sim.model.min_v
    )
    rho = fibrillation_density(img, sim.phase)
    print("rho = %.4f" % rho)
    report_rotors(res)

    checkpoint.save_state("state_small.npz", res.state, cfg)
    return res.state


def report_rotors(res):
    """Fibrillation complexity from the live on-device census
    (SimConfig.rotor_probe): rotor count complements rho, which only
    measures depolarized AREA — one stable rotor and a five-wavelet
    fibrillatory state can have the same rho."""
    if "rotors" not in res.probes:
        return
    r = res.probes["rotors"]
    tail = r[len(r) // 2:]
    print("rotors: mean %.2f  max %d  (last-half mean %.2f, net %+d)"
          % (r[:, 0].mean(), int(r[:, 0].max()),
             tail[:, 0].mean(), int(r[-1, 1])))


def run_large(cfg, cyclelengths, radius, i0=0, frames_ms=None):
    sim = Simulation(CourtemancheUltra(cfg))
    sim.add_hole_to_phase_field(cfg.width // 2, cfg.height // 2, radius)
    state, _ = checkpoint.load_state("state_small.npz")
    sim.define(state=state)
    sim.cl_observer = partial(cl_observer, sim, cyclelengths, i0)

    res = sim.simulate(record_frames_every_ms=frames_ms)
    report_rotors(res)
    checkpoint.save_state("state_large.npz", res.state, cfg)
    if res.frames is not None:
        from fib_tf_tpu.utils import viz

        viz.save_cube("cube_large", res.frames)
        print("saved cube_large.npy (quantify with: python -m fib_tf_tpu "
              "tips/dfmap cube_large.npy)")
    return res.state


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--duration", type=float, default=1000.0,
                    help="per-phase duration (reference used 10000)")
    ap.add_argument("--rotor", action="store_true",
                    help="live on-device rotor census (count + net "
                         "charge per outer step)")
    ap.add_argument("--frames", type=float, default=None,
                    help="record the large phase every N ms to "
                         "cube_large.npy for tips/dfmap quantification")
    args = ap.parse_args()
    cfg = SimConfig(
        width=args.size, height=args.size, dt=0.1, dt_per_plot=10,
        diff=1.5, duration=args.duration, ultra_slow=True,
        rotor_probe=args.rotor,
    )
    cyclelengths = []
    run_small(cfg, cyclelengths, radius=max(args.size // 50, 3))
    i0 = int(cfg.duration / cfg.dt)
    run_large(cfg, cyclelengths, radius=max(args.size // 5, 8), i0=i0,
              frames_ms=args.frames)
    if cyclelengths:
        np.savetxt("cyclelengths.dat", np.asarray(cyclelengths))


if __name__ == "__main__":
    main()
