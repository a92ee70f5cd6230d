#!/usr/bin/env python
"""Luo-Rudy 1991 spiral wave by wavefront truncation (cut-the-wave).

A zoo-extension experiment with no reference counterpart (the reference
ships Fenton/BR/Courtemanche spirals; this is the same signature
experiment on the classic stiff ventricular model).  The paper-standard
g_si = 0.09 gives APD90 ~366 ms — a wavelength (CV·APD ~ 2.2 cells/ms ×
366 ms ~ 800 cells) that cannot reenter on a 512² sheet — so, following
the LR1 spiral literature (Qu, Weiss & Garfinkel, Am J Physiol 1999,
who tune g_si down to shorten APD), the default here is g_si = 0.02
(APD90 ~88 ms, wavelength ~195 cells).

Initiation is the robust cut-the-wave protocol rather than S2 cross-field
pacing: an S1 plane wave is advanced to mid-sheet, the lower half of
EVERY state plane is reset to rest (cutting the wavefront and leaving
fully recovered tissue below), and the free end curls into a rotor.
At 512², dt = 0.02: one charge −1 rotor sustained for the full second
of sim time, meandering ~70×80 cells — LR1's signature hypermeander, vs
Fenton's circular core.

S2 quadrant pacing at this wavelength produces only transient reentry
(~1 extra cycle, scanned 200-450 ms at g_si 0.02/0.03) — the cut is the
reliable protocol at 512².
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.models import LuoRudy91
from fib_tf_tpu.utils import viz


def build_sim(size, duration, gsi, skip=False):
    cfg = SimConfig(
        width=size, height=size, dt=0.02, dt_per_plot=10, diff=0.809,
        duration=duration, skip=skip,
    )
    model = LuoRudy91(cfg)
    model.g_si = gsi
    return Simulation(model).define()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--duration", type=float, default=1000.0,
                    help="sim time after the cut (ms)")
    ap.add_argument("--gsi", type=float, default=0.02,
                    help="slow-inward conductance (paper 0.09; lower "
                         "shortens APD so the spiral fits the sheet)")
    ap.add_argument("--cut-at", type=float, default=None,
                    help="ms of S1 propagation before the wave is cut "
                         "(default: mid-sheet at CV ~2.2 cells/ms)")
    ap.add_argument("--skip", action="store_true",
                    help="multi-rate slow gates (x/d/f once per outer "
                         "step; AP error <0.01 mV)")
    args = ap.parse_args()

    n = args.size
    cut_at = args.cut_at
    if cut_at is None:
        cut_at = round(n / 2 / 2.2)  # S1 front at mid-sheet

    # stage 1: S1 plane wave (the built-in 1-column stripe) to mid-sheet
    res1 = build_sim(n, cut_at, args.gsi, args.skip).simulate()

    # the cut: lower half of every plane back to rest -> a free end at
    # mid-height facing fully recovered tissue
    state = {k: np.array(v) for k, v in res1.state.items()}
    rest = LuoRudy91(SimConfig(width=n, height=n, dt=0.02, duration=1)
                     ).initial_state(s1=False)
    for k in state:
        state[k][n // 2:, :] = rest[k][n // 2:, :]

    # stage 2: the free end curls
    sim = build_sim(n, args.duration, args.gsi, args.skip)
    every = min(25, max(args.duration / 4, sim.model.dt_per_step * 0.02))
    res = sim.simulate(state=state, record_frames_every_ms=every)

    frames = np.asarray(res.frames)
    active = (frames[-1] > 0.5).mean()
    print(f"g_si={args.gsi} cut@{cut_at:.0f} ms: "
          f"{res.elapsed:.2f} s wall for {args.duration:.0f} ms "
          f"({res.sim_seconds_per_wall_second:.2f}x real time), "
          f"final active fraction {active:.2f}")
    if active > 0.02:
        print("sustained reentry at the horizon")

    viz.save_cube("cube", frames)
    im = viz.Screen(n, n, "Luo-Rudy 1991")
    im.imshow(frames[-1])
    im.save("lr1_final.png")


if __name__ == "__main__":
    main()
