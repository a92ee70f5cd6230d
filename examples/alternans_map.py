#!/usr/bin/env python
"""Spatially discordant alternans on a fast-paced strip.

The classic wavebreak-precursor experiment (no reference counterpart —
the reference judged its screens by eye): pace one end of a conducting
strip close to the refractory limit and map the per-pixel beat-to-beat
APD difference.  Near the pacing site every beat alternates long-short
in one phase; further down the strip CV restitution delays alternate
wavefronts until the tissue alternates in the OPPOSITE phase — the
boundary is a nodal line of zero alternans, and steep-slope theory
puts conduction block (wavebreak) where the discordant gradient is
steepest.

The whole protocol is one batched program (engine/ensemble.py events
firing the pacing train inside the scan, the full potential plane as
the probe stream), and the analysis is `utils/apd.py::apd_map` — the
same tool the CLI exposes as `apdmap` for saved cubes.

Measured (tp06, dt=0.02, diff=0.809, 4x256 strip, BCL 330, 6 beats —
just above the model's 0D alternans rate): alternans grows 0.1 ->
26.1 ms along the strip, the signed ΔAPD changes sign near x~110 (the
node, a second near ~180), and ~19% of the tissue alternates out of
phase with the majority.  The steep-restitution tp06 is the demo
model by necessity: BR's dynamic slope at these rates is 0.43, and
its 0D alternans is exactly zero (measured) — shallow-restitution
models pace concordantly.

  python examples/alternans_map.py
  python examples/alternans_map.py --bcl 320 --width 384
  python examples/alternans_map.py --save-plot alternans.png
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine.ensemble import (
    EnsembleEvent, run_ensemble, stack_states,
)
from fib_tf_tpu.models import MODEL_REGISTRY
from fib_tf_tpu.utils.apd import apd_map, plot_apd_map

DIFF = {"fenton": 1.5, "br": 0.809, "ms": 1.5, "lr1": 0.809,
        "tp06": 0.809}
# near-refractory pacing rates per family (capture held, alternans
# engaged where the model's slope allows; tests/test_apdmap.py pins
# the tp06 measurement — BR/fenton at these rates are concordant)
BCL = {"fenton": 220.0, "br": 230.0, "ms": 250.0, "lr1": 300.0,
       "tp06": 330.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(DIFF), default="tp06")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=4)
    ap.add_argument("--bcl", type=float, default=None,
                    help="pacing cycle length in ms (default: the "
                         "model's near-refractory rate)")
    ap.add_argument("--beats", type=int, default=8)
    ap.add_argument("--stim-cols", type=int, default=4)
    ap.add_argument("--save-plot", default=None, metavar="PATH")
    args = ap.parse_args()

    model_cls = MODEL_REGISTRY[args.model]
    extra = {}
    if args.model == "br":
        extra = dict(cheby=True, skip=True)
    cfg = SimConfig(width=args.width, height=args.height,
                    dt=model_cls.default_dt, diff=DIFF[args.model],
                    duration=10, **extra)
    model = model_cls(cfg)
    dt_ms = model.dt_per_step * cfg.dt
    bcl = args.bcl if args.bcl is not None else BCL[args.model]

    mask = np.full((args.height, args.width), model.min_v, np.float32)
    mask[:, :args.stim_cols] = {"fenton": 1.0, "ms": 1.0}.get(
        args.model, 0.0)
    beats = [int(round(10.0 / dt_ms)) + k * int(round(bcl / dt_ms))
             for k in range(args.beats)]
    # the tail must let the FINAL beat repolarize at every pixel — a
    # pixel whose last beat is cut off reads an earlier beat pair,
    # which flips its phase in the signed map (utils/apd.py docstring)
    n_outer = beats[-1] + int(round(400.0 / dt_ms))
    events = [EnsembleEvent(step=int(s), mask=mask) for s in beats]
    pot = model.pot_key

    stacked = stack_states([model.initial_state(s1=False)])
    _, movie = run_ensemble(model, stacked, n_outer, events=events,
                            probe=lambda s: s[pot])
    r = apd_map(np.asarray(movie)[0], frame_ms=dt_ms)

    signed = np.where(r.valid, r.apd_last - r.apd_prev, np.nan)
    row = signed[args.height // 2]
    finite = np.isfinite(row)
    sign_changes = int((np.diff(np.sign(row[finite])) != 0).sum())
    print(f"{args.model} strip {args.height}x{args.width}, BCL "
          f"{bcl:.0f} ms x {args.beats} beats (one batched program)")
    if not r.valid.any():
        print("no pixel completed two beats (BCL below the refractory "
              "limit?) — try a longer --bcl")
        return
    print(f"capture: {r.valid.mean() * 100:.0f}% of tissue; alternans "
          f"{np.nanmin(r.alternans):.1f} -> {np.nanmax(r.alternans):.1f} "
          "ms along the strip")
    d = r.discordance
    if d is not None and sign_changes:
        print(f"DISCORDANT: {d * 100:.0f}% of tissue out of phase, "
              f"{sign_changes} nodal line(s) on the mid row")
    elif d is not None:
        print(f"concordant (discordance {d:.2f}, no mid-row node)")
    if args.save_plot:
        plot_apd_map(args.save_plot, r)
        print(f"saved {args.save_plot}")


if __name__ == "__main__":
    main()
