#!/usr/bin/env python
"""S2-timing (vulnerable window) scan as ONE batched device program.

The classic induction experiment behind the reference's spiral runs
(fenton.py:155-187 fires a single hand-tuned S2 at 210 ms): an S1 plane
wave, then a premature S2 in the left-upper quadrant.  Too early — the
tissue is refractory and the S2 dies; too late — it propagates everywhere
and exits; in between lies the vulnerable window where unidirectional
block curls the wave into a reentrant spiral.

The reference could only probe the window serially, one full simulation
per S2 time.  Here the whole scan is one `run_ensemble` call: members
differ only in their per-member S2 step (EnsembleEvent), so the device
runs the entire window in a single vmapped scan — and the ensemble axis
shards over a mesh for free.

  python examples/s2_scan.py                     # 16 members, 512^2
  python examples/s2_scan.py --size 256 --members 24 --s2-from 80 --s2-to 260
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine.ensemble import s2_scan
from fib_tf_tpu.models import Fenton4v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--s2-from", type=float, default=150.0,
                    help="earliest S2 time (ms)")
    ap.add_argument("--s2-to", type=float, default=300.0,
                    help="latest S2 time (ms)")
    ap.add_argument("--duration", type=float, default=700.0,
                    help="total simulated ms; must leave time after the "
                         "latest S2 for failed inductions to die out")
    ap.add_argument("--save-plot", default=None, metavar="PATH",
                    help="save a member x time heatmap of the probe "
                         "voltage with per-member outcomes (PNG)")
    args = ap.parse_args()

    n = args.size
    cfg = SimConfig(width=n, height=n, dt=0.1, diff=1.5,
                    duration=args.duration)
    model = Fenton4v(cfg)

    ms_per_outer = cfg.dt * model.dt_per_step
    s2_ms = np.linspace(args.s2_from, args.s2_to, args.members)
    s2_steps = np.round(s2_ms / ms_per_outer).astype(np.int32)
    n_outer = int(round(args.duration / ms_per_outer))

    steps, sustained, probes = s2_scan(
        model, n_outer, s2_steps, s2_loc="luq"
    )

    print(f"S2 scan: {args.members} members, {n}x{n}, "
          f"{args.duration:.0f} ms each (one batched program)")
    for t, hit in zip(s2_ms, sustained):
        print(f"  S2 @ {t:6.1f} ms -> {'REENTRY' if hit else 'died out'}")
    window = s2_ms[sustained]
    if len(window):
        print(f"vulnerable window: [{window.min():.1f}, {window.max():.1f}] ms")
    else:
        print("no reentry induced in the scanned range")

    if args.save_plot:
        save_plot(args.save_plot, s2_ms, sustained, probes, ms_per_outer)
        print(f"saved {args.save_plot}")


def save_plot(path, s2_ms, sustained, probes, ms_per_outer):
    """Member x time heatmap of the normalized probe voltage.

    One row per S2 time; a white tick marks each member's S2 delivery;
    outcomes are written as text at the right edge (identity is never
    color-alone).  Sequential single-hue colormap for the magnitude."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n, n_outer = probes.shape
    t_max = n_outer * ms_per_outer
    fig, ax = plt.subplots(
        figsize=(8.0, 0.28 * n + 1.2), constrained_layout=True
    )
    ax.imshow(
        probes, aspect="auto", cmap="Blues", vmin=0.0, vmax=1.0,
        extent=(0, t_max, n - 0.5, -0.5), interpolation="nearest",
    )
    for i, (t, hit) in enumerate(zip(s2_ms, sustained)):
        ax.plot([t, t], [i - 0.38, i + 0.38], color="white", lw=1.6)
        ax.text(
            t_max * 1.01, i, "reentry" if hit else "died out",
            va="center", fontsize=8,
            color="#0b0b0b" if hit else "#52514e",
            fontweight="bold" if hit else "normal",
        )
    ax.set_yticks(range(n))
    ax.set_yticklabels([f"{t:.0f}" for t in s2_ms], fontsize=8)
    ax.set_ylabel("S2 time (ms)")
    ax.set_xlabel("simulated time (ms)")
    ax.set_title(
        "S2 vulnerable-window scan — probe voltage per member\n"
        "(one batched device program; white tick = S2 delivery)",
        fontsize=10,
    )
    ax.tick_params(length=0)
    for s in ax.spines.values():
        s.set_visible(False)
    ax.set_xlim(0, t_max * 1.14)
    fig.savefig(path, dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    main()
