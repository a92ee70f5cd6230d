#!/usr/bin/env python
"""Channel-block (drug) dose-response: AP prolongation under IKr block.

The standard safety-pharmacology experiment: scale a channel's maximal
conductance (SimConfig.g_scale — 0.5 = 50% block) and read out the APD90
dose-response.  hERG/IKr block (the dofetilide class, and the liability
every QT-safety screen tests for) PROLONGS the action potential; L-type
Ca block (verapamil class) SHORTENS it.  The reference had no
pharmacology interface at all — its one hard-coded intervention was the
global chronic-AF flag (court.py:193-194).

Factors are trace-time constants folded into the compiled step (zero
runtime cost, every execution path), so each dose is one small compiled
0D program; the whole fan runs in seconds on CPU.

  python examples/drug_block.py                          # tp06, IKr fan
  python examples/drug_block.py --channel g_CaL          # Ca-block fan
  python examples/drug_block.py --model court --channel g_Kr
  python examples/drug_block.py --save-plot drug.png

Dose can also be SPATIAL (tp06 only): `--border F` attaches a per-pixel
IKr dose-factor plane (`set_het(g_kr=...)`) blocking the left half of a
strip at factor F, paces the whole strip uniformly, and reports the
APD90 step across the dose border — the dispersion substrate for
unidirectional block:

  python examples/drug_block.py --border 0.25

(The --border strip runs in about a minute on the CPU.)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))


import argparse

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import MODEL_REGISTRY, cell_geometry

# stimulus jump (mV or normalized) + trace length (outer steps) per model
PROTO = {
    "tp06": (-60.0, 2500, 1000),
    "court": (-55.0, 2200, 500),
    "br": (-30.0, 1200, 200),
    "lr1": (-30.0, 2500, 200),
}


def _apd90(rest, tr, ms_per_sample):
    peak = tr.max()
    thr = peak - 0.9 * (peak - rest)
    i_peak = int(tr.argmax())
    up = np.where(tr >= thr)[0][0]
    below = np.where(tr[i_peak:] < thr)[0]
    if not len(below):
        return float("nan")  # repolarization failure at this dose
    return (i_peak + below[0] - up) * ms_per_sample


def run_dose(model_name, channel, factor):
    """One compiled 0D program: quiesce, suprathreshold jump, V trace."""
    stim_v, n_ap, n_quiet = PROTO[model_name]
    cls = MODEL_REGISTRY[model_name]
    cfg = SimConfig(width=4, height=4, dt=cls.default_dt, duration=1,
                    g_scale=None if factor == 1.0 else {channel: factor})
    model = cls(cfg)
    geom = cell_geometry()

    def trace(state, n):
        def body(s, _):
            s = model.step(s, geom)
            return s, s[model.pot_key][0, 0]

        return jax.jit(
            lambda s: jax.lax.scan(body, s, None, length=n)
        )({k: jnp.asarray(np.array(v)) for k, v in state.items()})

    quiet, _ = trace(model.initial_state(s1=False), n_quiet)
    quiet = jax.device_get(quiet)
    rest = float(quiet["V"][0, 0]) if "V" in quiet else float(quiet["u"][0, 0])
    st = {k: np.array(v) for k, v in quiet.items()}
    st[model.pot_key] = np.full_like(st[model.pot_key], stim_v)
    _, tr = trace(st, n_ap)
    tr = np.asarray(tr)
    ms = model.dt_per_step * cfg.dt
    return rest, tr, ms


def run_border(factor, width=64, height=4, save_plot=None):
    """Half-dosed tp06 strip under uniform pacing: APD90 per column,
    printed as the step across the dose border (left half blocked)."""
    from fib_tf_tpu.models import TenTusscher06, grid_geometry

    cfg = SimConfig(width=width, height=height, dt=0.02, duration=1)
    plane = np.ones((height, width), np.float32)
    plane[:, : width // 2] = factor
    model = TenTusscher06(cfg).set_het(g_kr=plane)
    geom = grid_geometry()
    row = height // 2

    def trace(state, n):
        def body(s, _):
            s = model.step(s, geom)
            return s, s["V"][row, :]

        return jax.jit(
            lambda s: jax.lax.scan(body, s, None, length=n)
        )({k: jnp.asarray(np.array(v)) for k, v in state.items()})

    quiet, _ = trace(model.initial_state(s1=False), 1000)
    quiet = jax.device_get(quiet)
    rest = float(np.asarray(quiet["V"]).mean())
    st = {k: np.array(v) for k, v in quiet.items()}
    st["V"] = np.full_like(st["V"], -60.0)
    _, tr = trace(st, 2500)  # [T, width] row trace
    tr = np.asarray(tr)
    ms = model.dt_per_step * cfg.dt

    apds = np.array([_apd90(rest, tr[:, x], ms) for x in range(width)])
    left = float(np.nanmean(apds[2: width // 2 - 2]))
    right = float(np.nanmean(apds[width // 2 + 2: -2]))
    print(f"tp06 strip {height}x{width}, left half g_Kr x {factor:g}:")
    print(f"  APD90 blocked side {left:.1f} ms | control side "
          f"{right:.1f} ms | step {left - right:+.1f} ms")
    if save_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.plot(apds, ".-")
        ax.axvline(width / 2 - 0.5, ls="--", color="gray")
        ax.set(xlabel="column", ylabel="APD90 (ms)",
               title=f"APD step across the g_Kr x {factor:g} border")
        fig.tight_layout()
        fig.savefig(save_plot, dpi=120)
        print(f"saved {save_plot}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(PROTO), default="tp06")
    ap.add_argument("--channel", default=None,
                    help="channel to block (model's SCALE_PARAMS; "
                         "default: the model's repolarizing K current — "
                         "g_Kr for tp06/court (the hERG liability), "
                         "g_x1 for br, g_K for lr1)")
    ap.add_argument("--doses", default="1.0,0.75,0.5,0.25",
                    help="conductance factors, 1.0 = drug-free")
    ap.add_argument("--border", type=float, default=None, metavar="F",
                    help="spatial mode (tp06): block the left half of a "
                         "strip at factor F via a per-pixel g_kr dose "
                         "plane and report the APD step across the "
                         "border")
    ap.add_argument("--width", type=int, default=64,
                    help="strip length for --border")
    ap.add_argument("--save-plot", default=None)
    args = ap.parse_args()

    if args.border is not None:
        if args.model != "tp06":
            raise SystemExit("--border needs --model tp06 (the g_kr "
                             "dose plane lives there)")
        run_border(args.border, width=args.width,
                   save_plot=args.save_plot)
        return

    if args.channel is None:
        args.channel = {"tp06": "g_Kr", "court": "g_Kr",
                        "br": "g_x1", "lr1": "g_K"}[args.model]
    doses = [float(d) for d in args.doses.split(",")]
    print(f"{args.model}: {args.channel} dose-response "
          f"(factor 1.0 = drug-free)")
    print(f"{'factor':>8} {'APD90 (ms)':>11} {'ΔAPD (ms)':>10}")
    results = []
    apd_ctrl = None
    for f in doses:
        rest, tr, ms = run_dose(args.model, args.channel, f)
        apd = _apd90(rest, tr, ms)
        if apd_ctrl is None:
            apd_ctrl = apd
        d = apd - apd_ctrl
        tag = "  (repol failure)" if np.isnan(apd) else ""
        print(f"{f:8.2f} {apd:11.1f} {d:+10.1f}{tag}")
        results.append((f, tr, ms, apd))

    if args.save_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        for f, tr, ms, _ in results:
            t = np.arange(len(tr)) * ms
            ax1.plot(t, tr, label=f"{args.channel} x {f:g}")
        ax1.set(xlabel="t (ms)", ylabel="V (mV)",
                title=f"{args.model}: AP under {args.channel} block")
        ax1.legend(fontsize=8)
        ax2.plot([f for f, *_ in results],
                 [a for *_, a in results], "o-")
        ax2.set(xlabel=f"{args.channel} factor", ylabel="APD90 (ms)",
                title="dose-response")
        ax2.invert_xaxis()
        fig.tight_layout()
        fig.savefig(args.save_plot, dpi=120)
        print(f"saved {args.save_plot}")


if __name__ == "__main__":
    main()
