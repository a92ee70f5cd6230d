#!/usr/bin/env python
"""Transmural APD-dispersion map on a heterogeneous tp06 wedge.

The canonical heterogeneous-substrate experiment (no reference
counterpart — the reference's tissue was homogeneous): a strip whose
columns are endo / M / epi bands (SimConfig.cell_type='transmural',
realized as per-pixel g_to / g_Ks / endo-s-gate planes riding the state
dict, models/tp06.transmural_planes), paced from the endocardial edge
the way a wedge preparation activates.  M cells (G_Ks 0.098 vs 0.392)
repolarize last, so the per-column APD90 profile rises from ~300 ms in
the endo band to a long-APD M dome and falls back in the epi band —
the transmural dispersion of repolarization that underlies T-wave
morphology and the vulnerability of the M-epi gradient to unidirectional
block.  Electrotonic coupling smooths the 0D step (endo 300.6 / M 409.8
/ epi 302.6 ms, tests/test_tp06.py) into a continuous gradient whose
width is set by the space constant, not the band edges.

Protocol: 3 beats at BCL 800 ms from the left (endo) edge; per-pixel
APD90 via utils/apd.apd_map (the `apdmap` machinery); prints per-band
mean APD, the transmural dispersion, and the border gradient widths.

Measured (defaults: 4x256 strip, dt=0.02, diff=0.809, bands 0.25/0.60):
endo 298.3, M 388.3, epi 302.8 ms band-center means; dispersion 96.7 ms;
full capture, no truncated pixels
(tests/test_tp06.py::TestTransmuralWedge pins these).

  python examples/tp06_transmural.py
  python examples/tp06_transmural.py --bands 0.3,0.7 --save-plot apd.png
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse
import json

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine.ensemble import (
    EnsembleEvent, run_ensemble, stack_states,
)
from fib_tf_tpu.models import TenTusscher06
from fib_tf_tpu.utils.apd import apd_map, plot_apd_map


def run(width=256, height=4, bcl=800.0, beats=3, bands=(0.25, 0.60),
        stim_cols=4):
    cfg = SimConfig(width=width, height=height, dt=0.02, diff=0.809,
                    duration=10, cell_type="transmural",
                    cell_type_bands=tuple(bands))
    model = TenTusscher06(cfg)
    dt_ms = model.dt_per_step * cfg.dt

    mask = np.full((height, width), model.min_v, np.float32)
    mask[:, :stim_cols] = 0.0
    steps = [int(round(10.0 / dt_ms)) + k * int(round(bcl / dt_ms))
             for k in range(beats)]
    # tail: the M dome needs ~APD_max + conduction past the last beat
    # or apd_map flags the pixels truncated (utils/apd.py)
    n_outer = steps[-1] + int(round(500.0 / dt_ms))
    events = [EnsembleEvent(step=int(s), mask=mask) for s in steps]

    stacked = stack_states([model.initial_state(s1=False)])
    _, movie = run_ensemble(model, stacked, n_outer, events=events,
                            probe=lambda s: s["V"])
    return apd_map(np.asarray(movie)[0], frame_ms=dt_ms), cfg


def band_stats(r, cfg):
    """Per-band mean APD90 (center half of each band, away from the
    electrotonic border gradients) + the transmural dispersion."""
    b0, b1 = cfg.cell_type_bands
    w = cfg.width
    prof = np.nanmean(np.where(r.valid, r.apd_last, np.nan), axis=0)
    edges = {"endo": (0, int(b0 * w)), "m": (int(b0 * w), int(b1 * w)),
             "epi": (int(b1 * w), w)}
    out = {}
    for name, (lo, hi) in edges.items():
        q = (hi - lo) // 4
        out[name] = float(np.nanmean(prof[lo + q:hi - q]))
    out["dispersion_ms"] = float(np.nanmax(prof) - np.nanmin(prof))
    return out, prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=4)
    ap.add_argument("--bcl", type=float, default=800.0)
    ap.add_argument("--beats", type=int, default=3)
    ap.add_argument("--bands", default="0.25,0.60",
                    help="endo|M and M|epi border column fractions")
    ap.add_argument("--save-plot", default=None, metavar="PATH")
    args = ap.parse_args()

    bands = tuple(float(v) for v in args.bands.split(","))
    r, cfg = run(width=args.width, height=args.height, bcl=args.bcl,
                 beats=args.beats, bands=bands)
    if not r.valid.any():
        print("no pixel completed two beats — lengthen --bcl")
        return
    stats, _ = band_stats(r, cfg)
    stats = {k: round(v, 1) for k, v in stats.items()}
    print(json.dumps({
        "strip": f"{args.height}x{args.width}", "bcl_ms": args.bcl,
        "bands": bands, "apd90_ms": {k: stats[k]
                                     for k in ("endo", "m", "epi")},
        "dispersion_ms": stats["dispersion_ms"],
        "valid_fraction": round(float(r.valid.mean()), 3),
        "truncated_fraction": round(r.truncated_fraction, 3),
    }))
    if args.save_plot:
        plot_apd_map(args.save_plot, r)
        print(f"saved {args.save_plot}")


if __name__ == "__main__":
    main()
