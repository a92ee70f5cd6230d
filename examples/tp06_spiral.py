#!/usr/bin/env python
"""ten Tusscher-Panfilov 2006 spiral wave by wavefront truncation.

A zoo-extension experiment with no reference counterpart: the same
signature spiral experiment the reference ran on Fenton/BR/Courtemanche
(fenton.py:155-187 protocol family), on the de-facto standard modern
HUMAN ventricular model.  The TP06 paper itself (Am J Physiol 291:
H1088, Fig 7) studies exactly this regime: reentry on a 600x600 sheet,
rotation period ~265 ms, with the default parameter set's restitution
slope ~1.1 placing it at the edge of the alternans/breakup boundary.

Initiation is the robust cut-the-wave protocol (as in lr1_spiral.py):
an S1 plane wave is advanced to mid-sheet, the lower half of EVERY
state plane is reset to the paper's initial conditions (cutting the
wavefront and leaving fully recovered tissue below), and the free end
curls into a rotor.

The default diff=0.15 is MEASURED, not arbitrary: at the zoo's
standard 0.809 the wavelength (APD90 302 ms x CV 2.22 cells/ms ~ 660
cells) exceeds the 512 sheet and the free end escapes off the edge
before completing a turn (active fraction -> 0 by ~500 ms; runs at
0.809 and 0.3 both extinguish).  At 0.15 (CV ~ 0.96) a single
+1 rotor sustains: tracked 58/60 frames over 1500 ms, meander
20 x 111 cells, period ~375 ms, rotor-shortened median APD 220 ms
(vs 302 paced) with 22 ms median APD alternans and 13% discordant
area (`tips` / `dfmap` / `apdmap` on the saved cube) — the steep-
restitution regime the paper's breakup analysis studies.
`--cell-type m` runs the long-APD midwall variant.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.models import TenTusscher06
from fib_tf_tpu.utils import viz


def build_sim(size, duration, cell_type, diff, skip=False):
    cfg = SimConfig(
        width=size, height=size, dt=0.02, dt_per_plot=10, diff=diff,
        duration=duration, skip=skip,
    )
    model = TenTusscher06(cfg)
    model.cell_type = cell_type
    return Simulation(model).define()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--duration", type=float, default=2000.0,
                    help="sim time after the cut (ms); the paper's "
                         "rotation period is ~265 ms, so >=1000 shows "
                         "several turns")
    ap.add_argument("--diff", type=float, default=0.15,
                    help="diffusion coefficient (cells^2/ms); the "
                         "default 0.15 fits the rotor on a 512 sheet "
                         "(at 0.809 the ~660-cell wavelength escapes "
                         "before the first turn — measured, see "
                         "docstring); lower shrinks the rotor further")
    ap.add_argument("--cell-type", default="epi",
                    choices=["epi", "endo", "m"])
    ap.add_argument("--cut-at", type=float, default=None,
                    help="ms of S1 propagation before the wave is cut "
                         "(default: front at ~2/3 sheet height)")
    ap.add_argument("--skip", action="store_true",
                    help="multi-rate slow gates (f/f2/s/xr1/xs once per "
                         "outer step; 0D AP error <0.2 mV - "
                         "tests/test_tp06.py)")
    args = ap.parse_args()

    n = args.size
    cut_at = args.cut_at
    if cut_at is None:
        # tp06 CV at diff=0.809 measured 2.22 cells/ms (plane wave,
        # -40 mV crossings at x=60/200 on a 256 strip); ~sqrt(diff)
        cv = 2.22 * np.sqrt(args.diff / 0.809)
        cut_at = round(2 * n / 3 / cv)

    # stage 1: S1 plane wave (the built-in 1-column stripe) toward the
    # top of the sheet
    res1 = build_sim(n, cut_at, args.cell_type, args.diff,
                     args.skip).simulate()

    # the cut: lower half of every plane back to the paper's initial
    # conditions -> a free end at mid-height facing recovered tissue
    state = {k: np.array(v) for k, v in res1.state.items()}
    rest = TenTusscher06(
        SimConfig(width=n, height=n, dt=0.02, duration=1)
    ).initial_state(s1=False)
    for k in state:
        state[k][n // 2:, :] = rest[k][n // 2:, :]

    # stage 2: the free end curls
    sim = build_sim(n, args.duration, args.cell_type, args.diff,
                    args.skip)
    every = min(25, max(args.duration / 4, sim.model.dt_per_step * 0.02))
    res = sim.simulate(state=state, record_frames_every_ms=every)

    frames = np.asarray(res.frames)
    active = (frames[-1] > 0.5).mean()
    print(f"tp06/{args.cell_type} cut@{cut_at:.0f} ms: "
          f"{res.elapsed:.2f} s wall for {args.duration:.0f} ms "
          f"({res.sim_seconds_per_wall_second:.2f}x real time), "
          f"final active fraction {active:.2f}")
    if active > 0.02:
        print("sustained reentry at the horizon")

    viz.save_cube("cube", frames)
    im = viz.Screen(n, n, "ten Tusscher-Panfilov 2006")
    im.imshow(frames[-1])
    im.save("tp06_final.png")


if __name__ == "__main__":
    main()
