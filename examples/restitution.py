#!/usr/bin/env python
"""APD restitution curve as ONE batched device program.

The restitution curve — action-potential duration vs the preceding
diastolic interval (DI) — is the standard dynamic fingerprint of a
cardiac model: a maximum slope above 1 predicts APD alternans and
wavebreak (the mechanism behind the spiral breakup the reference's
court_ultra runs chase).  The reference had no restitution tooling at
all; each point of a curve would have been a separate serial process.

Here every S2 coupling interval is one ensemble member
(engine/restitution.py): an S1 train at shared steps, the per-member S2
via EnsembleEvent, the whole protocol a single vmapped scan.  Uniform
full-field stimulation makes the small sheet behave as a single cell,
so this runs in seconds even on CPU.

  python examples/restitution.py                       # fenton, 24 points
  python examples/restitution.py --model br --bcl 500
  python examples/restitution.py --save-plot restitution.png

The dynamic (steady-state-pacing) protocol — one BCL per member, the
readout alternans analyses are built on (ten Tusscher & Panfilov 2006)
— is `--dynamic`: the last two APDs per rate give the beat-to-beat
alternans directly, and dropped beats report as loss of 1:1 capture.

  python examples/restitution.py --model tp06 --dynamic \
      --ci-from 260 --ci-to 600 --members 12
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine.restitution import restitution_scan
from fib_tf_tpu.models import MODEL_REGISTRY

DIFF = {"fenton": 1.5, "br": 0.809, "court": 0.809, "ms": 1.5,
        "lr1": 0.809, "tp06": 0.809}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(DIFF), default="fenton")
    ap.add_argument("--size", type=int, default=16,
                    help="sheet edge (uniform stimulation: any small "
                         "size behaves as a single cell)")
    ap.add_argument("--members", type=int, default=24)
    ap.add_argument("--ci-from", type=float, default=120.0,
                    help="shortest S2 coupling interval (ms)")
    ap.add_argument("--ci-to", type=float, default=500.0,
                    help="longest S2 coupling interval (ms)")
    ap.add_argument("--bcl", type=float, default=400.0,
                    help="S1 basic cycle length (ms)")
    ap.add_argument("--n-s1", type=int, default=2)
    ap.add_argument("--dynamic", action="store_true",
                    help="steady-state-pacing protocol: --ci-from/--ci-to "
                         "become the BCL range; reports per-rate APD "
                         "alternans and 1:1-capture loss")
    ap.add_argument("--beats", type=int, default=8,
                    help="pacing-train length per member (--dynamic)")
    ap.add_argument("--save-plot", default=None, metavar="PATH")
    args = ap.parse_args()

    model_cls = MODEL_REGISTRY[args.model]
    cfg = SimConfig(width=args.size, height=args.size,
                    dt=model_cls.default_dt,
                    diff=DIFF[args.model], duration=10)
    model = model_cls(cfg)

    if args.dynamic:
        run_dynamic(args, model)
        return

    coupling = np.linspace(args.ci_from, args.ci_to, args.members)
    r = restitution_scan(
        model, coupling_ms=coupling, bcl_ms=args.bcl, n_s1=args.n_s1,
        tail_ms=max(600.0, args.bcl),
    )

    print(f"{args.model} restitution: {args.members} couplings in "
          f"[{args.ci_from:.0f}, {args.ci_to:.0f}] ms, one batched program")
    print(f"S1 APD{90}: {r.apd_s1_ms:.1f} ms "
          f"(BCL {args.bcl:.0f} ms x {args.n_s1})")
    print(f"{'CI (ms)':>8} {'DI (ms)':>8} {'APD90 (ms)':>10}")
    for ci, di, apd, cap in zip(
        r.coupling_ms, r.di_ms, r.apd_ms, r.captured
    ):
        if cap:
            print(f"{ci:8.1f} {di:8.1f} {apd:10.1f}")
        else:
            print(f"{ci:8.1f} {'—':>8} {'no capture':>10}")
    s = r.slope()
    if s is not None:
        print(f"max slope dAPD/dDI: {s:.2f}"
              + ("  (>1: alternans-prone)" if s > 1 else ""))

    if args.save_plot:
        save_plot(args.save_plot, args.model, r)
        print(f"saved {args.save_plot}")


def run_dynamic(args, model):
    from fib_tf_tpu.engine.restitution import dynamic_restitution_scan

    bcl = np.linspace(args.ci_from, args.ci_to, args.members)
    r = dynamic_restitution_scan(
        model, bcl_ms=bcl, n_beats=args.beats,
        tail_ms=max(500.0, float(bcl.max())),
    )
    print(f"{args.model} dynamic restitution: {args.members} rates in "
          f"[{args.ci_from:.0f}, {args.ci_to:.0f}] ms x {args.beats} "
          "beats, one batched program")
    print(f"{'BCL (ms)':>9} {'DI (ms)':>8} {'APD90 (ms)':>10} "
          f"{'alternans':>9}")
    for b, di, apd, alt, cap in zip(r.bcl_ms, r.di_ms, r.apd_ms,
                                    r.alternans_ms, r.captured):
        if cap:
            flag = "  <- alternans" if alt > 10.0 else ""
            print(f"{b:9.1f} {di:8.1f} {apd:10.1f} {alt:9.1f}{flag}")
        else:
            print(f"{b:9.1f} {'—':>8} {'no 1:1 capture':>14}")
    s = r.slope()
    if s is not None:
        print(f"max dynamic slope dAPD/dDI: {s:.2f}"
              + ("  (>1: alternans-prone)" if s > 1 else ""))
    if args.save_plot:
        save_dynamic_plot(args.save_plot, args.model, r)
        print(f"saved {args.save_plot}")


def save_dynamic_plot(path, name, r):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax, ax2) = plt.subplots(
        1, 2, figsize=(8.4, 3.6), constrained_layout=True)
    m = r.captured
    # last two beats per rate: the split marks alternans
    ax.plot(r.bcl_ms[m], r.apd_prev_ms[m], "s-", color="#9a9892",
            ms=4, lw=1.1, label="beat n-1")
    ax.plot(r.bcl_ms[m], r.apd_ms[m], "o-", color="#3d6fd6", ms=4,
            lw=1.4, label="beat n")
    ax.set_xlabel("basic cycle length (ms)")
    ax.set_ylabel("APD90 (ms)")
    ax.set_title(f"{name} dynamic restitution", fontsize=10)
    ax.legend(fontsize=8, frameon=False)
    ax2.plot(r.bcl_ms[m], r.alternans_ms[m], "o-", color="#c24f3f",
             ms=4, lw=1.4)
    ax2.set_xlabel("basic cycle length (ms)")
    ax2.set_ylabel("|ΔAPD| beat-to-beat (ms)")
    ax2.set_title("APD alternans", fontsize=10)
    for a in (ax, ax2):
        for s in ("top", "right"):
            a.spines[s].set_visible(False)
    fig.savefig(path, dpi=150)
    plt.close(fig)


def save_plot(path, name, r):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.2, 3.8), constrained_layout=True)
    m = r.captured
    ax.plot(r.di_ms[m], r.apd_ms[m], "o-", color="#3d6fd6", ms=4, lw=1.4)
    ax.axhline(r.apd_s1_ms, color="#9a9892", lw=1.0, ls="--")
    ax.text(
        0.98, r.apd_s1_ms, f"S1 APD {r.apd_s1_ms:.0f} ms", va="bottom",
        ha="right", transform=ax.get_yaxis_transform(), fontsize=8,
        color="#52514e",
    )
    ax.set_xlabel("diastolic interval (ms)")
    ax.set_ylabel("APD90 (ms)")
    ax.set_title(f"{name} APD restitution (one batched scan)", fontsize=10)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.savefig(path, dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    main()
