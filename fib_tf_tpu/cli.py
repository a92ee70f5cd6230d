"""Command-line entry points.

The reference had no CLI (configs were dicts in __main__ blocks); this
gives every baseline configuration a reproducible invocation:

  python -m fib_tf_tpu run --model br --cheby --skip --duration 1000
  python -m fib_tf_tpu run --model fenton --hole 256,256,30 --s2 210 \
      --s2-loc luq --s2-v 1.0 --frames 10 --save-cube cube
  python -m fib_tf_tpu bench            # the reference Table-1 matrix
  python -m fib_tf_tpu table            # native lookup-table generation
  python -m fib_tf_tpu replay cube.npy
  python -m fib_tf_tpu tips cube.npy    # spiral-tip trajectories
  python -m fib_tf_tpu dfmap cube.npy   # dominant-frequency map
  python -m fib_tf_tpu filaments vol.npy  # 3D scroll filament census
  python -m fib_tf_tpu s2scan --members 16   # vulnerable-window ensemble
  python -m fib_tf_tpu restitution --model br   # APD restitution curve
  python -m fib_tf_tpu volume --depth 16 --s2 250   # 3D scroll wave
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import MODEL_REGISTRY


S2_DEFAULT_V = {"fenton": 1.0, "br": 10.0, "beeler_reuter": 10.0,
                "court": 10.0, "courtemanche": 10.0, "court_ultra": 10.0,
                "ms": 1.0, "mitchell_schaeffer": 1.0,
                "lr1": 20.0, "luo_rudy": 20.0,
                "tp06": 20.0, "tentusscher": 20.0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fib_tf_tpu")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend instead of the GPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a simulation")
    r.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="fenton")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--dt", type=float, default=None,
                   help="integration dt in ms (default: the model's "
                        "recommended dt — 0.1 for the reference models, "
                        "0.02 for the stiff lr1/tp06)")
    r.add_argument("--dt-per-plot", type=float, default=10)
    r.add_argument("--diff", type=float, default=None,
                   help="diffusion coefficient (model default if omitted)")
    r.add_argument("--fiber-angle", type=float, default=None,
                   help="fiber direction in degrees from x (anisotropic)")
    r.add_argument("--fiber-ratio", type=float, default=1.0,
                   help="cross-fiber conduction fraction (0, 1]")
    r.add_argument("--duration", type=float, default=1000)
    r.add_argument("--cheby", action="store_true", default=True)
    r.add_argument("--no-cheby", dest="cheby", action="store_false")
    r.add_argument("--skip", action="store_true")
    r.add_argument("--ab2", action="store_true",
                   help="Adams-Bashforth-2 for the Euler state updates "
                        "(fenton/br)")
    r.add_argument("--table", action="store_true",
                   help="use the voltage-indexed lookup table (court)")
    r.add_argument("--no-chronic", dest="chronic", action="store_false")
    r.add_argument("--cell-type",
                   choices=["epi", "endo", "m", "transmural"],
                   default="epi",
                   help="tp06 ventricular cell type; 'transmural' builds "
                        "the endo/M/epi banded wedge as per-pixel "
                        "parameter planes (--cell-type-bands)")
    r.add_argument("--cell-type-bands", default=None, metavar="B0,B1",
                   help="column fractions of the endo|M and M|epi "
                        "borders for --cell-type transmural "
                        "(default 0.25,0.60)")
    r.add_argument("--fibrosis", default=None,
                   metavar="DENSITY,STRENGTH[,SEED[,PATCH]]",
                   help="attach a patchy fibrotic diffusion map "
                        "(ops/stencil.fibrosis_map): DENSITY of the area "
                        "conducts at (1-STRENGTH) x diff; composes with "
                        "--hole and --fiber-angle on every mesh path")
    r.add_argument("--gscale", default=None, metavar="CH=F[,CH=F...]",
                   help="channel-block (drug) factors, e.g. g_Kr=0.5 "
                        "for 50%% IKr block (tp06/court/lr1/br; see "
                        "each model's SCALE_PARAMS); trace-time "
                        "constants folded into the compiled step")
    r.add_argument("--dv-max", type=float, default=None,
                   help="stability guard: cap |dV| per substep in mV "
                        "(court; default off = reference behavior)")
    r.add_argument("--adaptive-dv", type=float, default=None,
                   help="adaptive dt: re-take any substep that moves V "
                        "more than this many mV as two half-dt substeps "
                        "(step-doubling; the correct alternative to "
                        "--dv-max's clip; default off)")
    r.add_argument("--adaptive-depth", type=int, default=2,
                   help="max halvings for --adaptive-dv (dt/2**depth)")
    r.add_argument("--hole", action="append", default=[],
                   help="x,y,radius[,neg] — may repeat")
    r.add_argument("--s2", type=float, default=None,
                   help="S2 cross-stimulation time (ms)")
    r.add_argument("--s2-loc", default="luq")
    r.add_argument("--s2-v", type=float, default=None)
    r.add_argument("--frames", type=float, default=None,
                   help="record frames every N ms")
    r.add_argument("--save-cube", default=None)
    r.add_argument("--save-state", default=None)
    r.add_argument("--load-state", default=None)
    r.add_argument("--timeline", action="store_true")
    r.add_argument("--save-graph", action="store_true")
    r.add_argument("--electrode", action="append", default=[],
                   help="x,y,radius — may repeat; enables EGM probes")
    r.add_argument("--ecg", action="append", default=[],
                   help="x,y[,z] — far-field pseudo-ECG electrode z "
                        "cell units above the sheet (default z=5; may "
                        "repeat)")
    r.add_argument("--save-ecg", default=None,
                   help="save the [T, n_electrodes] pseudo-ECG (npy)")
    r.add_argument("--rotor", action="store_true",
                   help="emit the live rotor census [count, net charge] "
                        "per outer step from inside the compiled scan")
    r.add_argument("--rotor-tau", type=float, default=10.0,
                   help="rotor-probe embedding delay (ms)")
    r.add_argument("--mesh", default=None, metavar="R[xC]",
                   help="shard the grid over a device mesh: '4' = 4 row "
                        "shards, '2x2' = 2x2 rows x cols.  The default "
                        "mesh-mode 'auto' takes the shard_map wide-halo "
                        "path where the model/grid qualify")
    r.add_argument("--mesh-mode", choices=["auto", "spmd", "gspmd"],
                   default="auto",
                   help="sharded execution path for --mesh: 'spmd' "
                        "forces the explicit shard_map wide-halo path, "
                        "'gspmd' the XLA-inferred-collectives path, "
                        "'auto' picks spmd when the model/grid qualify")
    r.add_argument("--gspmd", dest="mesh_mode", action="store_const",
                   const="gspmd",
                   help="shorthand for --mesh-mode gspmd")

    b = sub.add_parser("bench", help="reference Table-1 benchmark matrix")
    b.add_argument("--duration", type=float, default=1000)
    b.add_argument("--size", type=int, default=512)
    b.add_argument("--runs", type=int, default=3,
                   help="repeats per row; the row reports median + "
                        "[min, max] spread (bench.py convention)")
    b.add_argument("--json", action="store_true",
                   help="one JSON line per row")

    t = sub.add_parser("table", help="generate the native lookup table")
    t.add_argument("--out", default=None, help="write .npy (default stdout)")
    t.add_argument("--golden", type=float, default=None,
                   help="print the 30 intermediates at this voltage")

    rp = sub.add_parser("replay", help="replay a cube.npy movie")
    rp.add_argument("path")
    rp.add_argument("--fps", type=float, default=40)

    tp = sub.add_parser(
        "tips",
        help="spiral-tip (phase-singularity) trajectories from a saved "
             "cube.npy movie",
    )
    tp.add_argument("path")
    tp.add_argument("--tau", type=int, default=2,
                    help="phase-embedding delay in frames")
    tp.add_argument("--max-jump", type=float, default=75.0,
                    help="max tip movement per frame when linking (cells; "
                         "default sized for 10 ms/frame cubes)")
    tp.add_argument("--max-gap", type=int, default=3,
                    help="missed frames a track may coast over")
    tp.add_argument("--min-length", type=int, default=5,
                    help="drop tracks shorter than this many detections")
    tp.add_argument("--json", action="store_true")
    tp.add_argument("--save-plot", default=None, metavar="PATH")

    fl = sub.add_parser(
        "filaments",
        help="scroll-wave filament census from a saved [T, D, H, W] "
             "volume movie (utils/filaments.py)",
    )
    fl.add_argument("path")
    fl.add_argument("--tau", type=int, default=2,
                    help="phase-embedding delay in frames")
    fl.add_argument("--link-dist", type=float, default=6.0,
                    help="max in-plane jump between adjacent z-slices "
                         "when linking (cells)")
    fl.add_argument("--min-span", type=int, default=2,
                    help="drop filaments threading fewer z-slices")
    fl.add_argument("--json", action="store_true")
    fl.add_argument("--save-plot", default=None, metavar="PATH",
                    help="save the peak frame's filament figure")

    df = sub.add_parser(
        "dfmap",
        help="dominant-frequency + organization-index maps from a saved "
             "cube.npy movie",
    )
    df.add_argument("path")
    df.add_argument("--frame-ms", type=float, default=10.0,
                    help="movie cadence (ms/frame)")
    df.add_argument("--f-min", type=float, default=1.0)
    df.add_argument("--f-max", type=float, default=None,
                    help="band top (default Nyquist)")
    df.add_argument("--json", action="store_true")
    df.add_argument("--save-plot", default=None, metavar="PATH")

    am = sub.add_parser(
        "apdmap",
        help="per-pixel APD + alternans maps (spatially discordant "
             "alternans) from a saved cube.npy movie",
    )
    am.add_argument("path")
    am.add_argument("--frame-ms", type=float, default=10.0,
                    help="movie cadence (ms/frame)")
    am.add_argument("--level", type=float, default=0.9,
                    help="repolarization level (0.9 = APD90)")
    am.add_argument("--json", action="store_true")
    am.add_argument("--save-plot", default=None, metavar="PATH")

    s2 = sub.add_parser(
        "s2scan",
        help="S2-timing vulnerable-window scan as one batched ensemble",
    )
    s2.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                    default="fenton")
    s2.add_argument("--width", type=int, default=512)
    s2.add_argument("--height", type=int, default=512)
    s2.add_argument("--dt", type=float, default=None,
                    help="integration dt in ms (default: model's "
                         "recommended dt)")
    s2.add_argument("--diff", type=float, default=None)
    s2.add_argument("--members", type=int, default=16)
    s2.add_argument("--s2-from", type=float, default=150.0)
    s2.add_argument("--s2-to", type=float, default=300.0)
    s2.add_argument("--s2-loc", default="luq")
    s2.add_argument("--duration", type=float, default=700.0)
    s2.add_argument("--json", action="store_true",
                    help="print one JSON line instead of the table")

    vo = sub.add_parser(
        "volume",
        help="3D scroll-wave run (run_volume; beyond reference parity)",
    )
    vo.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                    default="fenton")
    vo.add_argument("--depth", type=int, default=16)
    vo.add_argument("--width", type=int, default=128)
    vo.add_argument("--height", type=int, default=128)
    vo.add_argument("--dt", type=float, default=None,
                    help="must respect the 3D limit "
                         "2/((8+8*dz_ratio)*diff); default "
                         "min(0.05, model's recommended dt)")
    vo.add_argument("--diff", type=float, default=None)
    vo.add_argument("--duration", type=float, default=600.0)
    vo.add_argument("--dz-ratio", type=float, default=1.0,
                    help="transmural conduction fraction")
    vo.add_argument("--fiber-twist", type=float, default=0.0,
                    help="total transmural fiber rotation (degrees)")
    vo.add_argument("--fiber-ratio", type=float, default=1.0)
    vo.add_argument("--fiber-elevation", type=float, default=0.0,
                    help="imbrication angle (degrees) tilting the "
                         "fiber axis out of the sheet plane — full 3x3 "
                         "tensor (XLA path; needs --fiber-ratio < 1)")
    vo.add_argument("--s2", type=float, default=None,
                    help="cross-field S2 time (ms); makes a scroll wave")
    vo.add_argument("--s2-loc", default="luq")
    vo.add_argument("--s2-z-frac", type=float, default=0.5,
                    help="fraction of the depth the S2 covers (a partial"
                         "-depth S2 puts the filament end mid-wall)")
    vo.add_argument("--hole", action="append", default=[],
                    help="x,y,radius[,neg] — columnar obstacle; may "
                         "repeat")
    vo.add_argument("--rotor", action="store_true",
                    help="live per-slice rotor census stream")
    vo.add_argument("--ecg", action="append", default=[],
                    help="z,y,x — virtual unipolar electrode in cell "
                         "units (pseudo-ECG stream; may repeat; z<0 "
                         "floats the electrode above the epicardium — "
                         "use --ecg=-5,64,64 for negative z)")
    vo.add_argument("--save-ecg", default=None,
                    help="save the [T, n_electrodes] pseudo-ECG (npy)")
    vo.add_argument("--frames", type=float, default=None,
                    help="record [D,H,W] frames every N ms")
    vo.add_argument("--save-volume", default=None,
                    help="save the [T,D,H,W] movie (npy) for `filaments`")
    vo.add_argument("--save-cube", default=None,
                    help="save the mid-depth slice movie for `replay`")
    vo.add_argument("--json", action="store_true")

    rs = sub.add_parser(
        "restitution",
        help="S1-S2 APD restitution curve as one batched ensemble",
    )
    rs.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                    default="fenton")
    rs.add_argument("--size", type=int, default=16,
                    help="sheet edge; uniform stimulation makes any "
                         "small sheet behave as a single cell")
    rs.add_argument("--dt", type=float, default=None,
                    help="integration dt in ms (default: model's "
                         "recommended dt)")
    rs.add_argument("--diff", type=float, default=None)
    rs.add_argument("--members", type=int, default=24)
    rs.add_argument("--ci-from", type=float, default=120.0,
                    help="shortest S2 coupling interval (ms)")
    rs.add_argument("--ci-to", type=float, default=500.0,
                    help="longest S2 coupling interval (ms)")
    rs.add_argument("--bcl", type=float, default=400.0,
                    help="S1 basic cycle length (ms)")
    rs.add_argument("--n-s1", type=int, default=2)
    rs.add_argument("--dynamic", action="store_true",
                    help="dynamic (steady-state-pacing) protocol instead "
                         "of S1-S2: one basic cycle length per member "
                         "(--ci-from/--ci-to become the BCL range), "
                         "reporting the last two APDs and the "
                         "beat-to-beat alternans per rate")
    rs.add_argument("--beats", type=int, default=8,
                    help="pacing-train length per member (--dynamic)")
    rs.add_argument("--cv", action="store_true",
                    help="CV-restitution protocol instead of S1-S2 APD: "
                         "conducting strips (8 x max(128, --size)) with "
                         "left-edge column stimuli, reporting the S2 "
                         "wave's conduction velocity vs the DI it "
                         "propagates into")
    rs.add_argument("--gscale", default=None, metavar="CH=F[,CH=F...]",
                    help="channel-block (drug) factors, e.g. g_Kr=0.5 — "
                         "restitution under block is the standard "
                         "dose-response protocol")
    rs.add_argument("--json", action="store_true",
                    help="print one JSON line instead of the table")
    return p


DIFF_DEFAULT = {"fenton": 1.5, "br": 0.809, "beeler_reuter": 0.809,
                "court": 0.809, "courtemanche": 0.809, "court_ultra": 1.5}


def _default_diff(model_name: str) -> float:
    return DIFF_DEFAULT.get(model_name, 1.5)


def _resolve_dt(args, floor: float = None) -> float:
    """--dt if given, else the model's recommended dt
    (IonicModel.default_dt — 0.1 for the reference models, 0.02 for the
    stiff Luo-Rudy).  `floor` caps it (the 3D diffusion limit)."""
    dt = args.dt
    if dt is None:
        dt = MODEL_REGISTRY[args.model].default_dt
        if floor is not None:
            dt = min(dt, floor)
    return dt


def _parse_gscale(spec: Optional[str]):
    """'g_Kr=0.5,g_CaL=0.8' -> {'g_Kr': 0.5, 'g_CaL': 0.8}."""
    if spec is None:
        return None
    out = {}
    for part in spec.split(","):
        name, eq, val = part.partition("=")
        try:
            if not eq or not name.strip():
                raise ValueError
            out[name.strip()] = float(val)
        except ValueError:
            raise SystemExit(
                f"--gscale expects CH=FACTOR[,CH=FACTOR...], got {part!r}")
    return out


def _parse_mesh(spec: Optional[str]):
    """'8' -> (8,), '4x2' -> (4, 2)."""
    if spec is None:
        return None
    parts = spec.lower().split("x")
    if not 1 <= len(parts) <= 2 or not all(p.isdigit() for p in parts):
        raise SystemExit(f"--mesh expects R or RxC, got {spec!r}")
    return tuple(int(p) for p in parts)


def cmd_run(args) -> int:
    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.utils import checkpoint, viz

    cfg = SimConfig(
        width=args.width, height=args.height, dt=_resolve_dt(args),
        dt_per_plot=args.dt_per_plot,
        diff=args.diff if args.diff is not None else _default_diff(args.model),
        fiber_angle=(np.deg2rad(args.fiber_angle)
                     if args.fiber_angle is not None else None),
        fiber_ratio=args.fiber_ratio,
        duration=args.duration, cheby=args.cheby, skip=args.skip,
        ab2=args.ab2, table=args.table, chronic=args.chronic,
        dv_max=args.dv_max,
        adaptive_dv=args.adaptive_dv, adaptive_depth=args.adaptive_depth,
        timeline=args.timeline, save_graph=args.save_graph,
        rotor_probe=args.rotor, rotor_tau_ms=args.rotor_tau,
        ultra_slow=(args.model == "court_ultra"),
        mesh_shape=_parse_mesh(args.mesh), mesh_mode=args.mesh_mode,
        cell_type=args.cell_type, g_scale=_parse_gscale(args.gscale),
        **({"cell_type_bands": tuple(
            float(v) for v in args.cell_type_bands.split(","))}
           if args.cell_type_bands else {}),
    )
    model = MODEL_REGISTRY[args.model](cfg)
    sim = Simulation(model)
    if args.fibrosis:
        from fib_tf_tpu.ops import stencil

        parts = args.fibrosis.split(",")
        sim.set_diffusion_map(stencil.fibrosis_map(
            args.height, args.width,
            density=float(parts[0]), strength=float(parts[1]),
            seed=int(parts[2]) if len(parts) > 2 else 0,
            patch=int(parts[3]) if len(parts) > 3 else 4,
        ))
    for spec in args.hole:
        parts = spec.split(",")
        x, y, r = float(parts[0]), float(parts[1]), float(parts[2])
        neg = len(parts) > 3 and parts[3] in ("neg", "1", "true")
        sim.add_hole_to_phase_field(x, y, r, neg=neg)
    for spec in args.electrode:
        x, y, r = (float(v) for v in spec.split(","))
        sim.add_electrode(x, y, r)
    for spec in args.ecg:
        parts = [float(v) for v in spec.split(",")]
        sim.add_ecg_electrode(*parts)

    state = None
    if args.load_state:
        state, _ = checkpoint.load_state(args.load_state)
    sim.define(state=state)

    schedule = []
    if args.s2 is not None:
        v = args.s2_v if args.s2_v is not None else S2_DEFAULT_V[args.model]
        sim.add_pace_op("s2", args.s2_loc, v)
        schedule.append((args.s2, "s2"))

    res = sim.simulate(schedule=schedule,
                       record_frames_every_ms=args.frames)
    summary = {
        "model": args.model,
        "elapsed_s": round(res.elapsed, 4),
        "outer_steps": res.steps,
        "cell_updates_per_sec": round(res.cell_updates_per_sec),
        "realtime_factor": round(res.sim_seconds_per_wall_second, 3),
        "cycle_lengths": res.cycle_lengths[-5:],
    }
    if args.rotor:
        r = res.probes["rotors"]
        summary["rotors"] = {
            "mean_count": round(float(r[:, 0].mean()), 3),
            "max_count": int(r[:, 0].max()),
            "final_net_charge": int(r[-1, 1]),
        }
    if args.ecg:
        e = np.asarray(res.probes["ecg"])
        summary["ecg_p2p"] = [
            round(float(c.max() - c.min()), 4) for c in e.T
        ]
        if args.save_ecg:
            np.save(args.save_ecg, e)
    print(json.dumps(summary))
    if args.save_cube and res.frames is not None:
        viz.save_cube(args.save_cube, res.frames)
    if args.save_state:
        checkpoint.save_state(args.save_state, res.state, cfg)
    return 0


def cmd_bench(args) -> int:
    """The reference's Table 1 (details.md:387-392): BR 2x2 cheby/skip
    matrix, plus the Fenton final configuration.  Each row is the
    MEDIAN of --runs repeats with the [min, max] spread (VERDICT r4 #6:
    round-over-round matrix claims need error bars; same convention and
    JSON shape as bench.py)."""
    import statistics

    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.models import BeelerReuter, Fenton4v

    def bench_row(sim) -> dict:
        if args.json:
            # keep stdout one-JSON-line-per-row parseable: route the
            # cycle detector's reference-parity print into a no-op
            sim.cl_observer = lambda i, cl: None
        samples = []
        for _ in range(max(1, args.runs)):
            res = sim.simulate(check_finite=False)
            samples.append(res.elapsed / (args.duration / 1000.0))
        return {
            "value": round(statistics.median(samples), 4),
            "spread": [round(min(samples), 4), round(max(samples), 4)],
            "samples": len(samples),
            "unit": "wall-s/sim-s",
            "cell_updates_per_sec": round(res.cell_updates_per_sec),
        }

    for cheby in (False, True):
        for skip in (False, True):
            cfg = SimConfig(width=args.size, height=args.size, dt=0.1,
                            diff=0.809, duration=args.duration,
                            cheby=cheby, skip=skip)
            row = bench_row(Simulation(BeelerReuter(cfg)).define())
            rec = {"model": "br", "cheby": cheby, "skip": skip, **row}
            if args.json:
                print(json.dumps(rec))
            else:
                print(f"BR cheby={cheby!s:5} skip={skip!s:5}: "
                      f"{row['value']:.4f} wall-s/sim-s "
                      f"[{row['spread'][0]:.4f}, {row['spread'][1]:.4f}] "
                      f"(n={row['samples']}, "
                      f"{row['cell_updates_per_sec']/1e9:.2f} G "
                      "cell-updates/s)")

    cfg = SimConfig(width=args.size, height=args.size, dt=0.1, diff=1.5,
                    duration=args.duration)
    row = bench_row(Simulation(Fenton4v(cfg)).define())
    if args.json:
        print(json.dumps({"model": "fenton", **row}))
    else:
        print(f"Fenton 4v              : {row['value']:.4f} wall-s/sim-s "
              f"[{row['spread'][0]:.4f}, {row['spread'][1]:.4f}] "
              f"(n={row['samples']}, "
              f"{row['cell_updates_per_sec']/1e9:.2f} G cell-updates/s)")
    return 0


def cmd_table(args) -> int:
    from fib_tf_tpu.models.courtemanche import (
        INTER_KEYS, calc_intermediates_np,
    )
    from fib_tf_tpu.ops import table as table_ops
    from fib_tf_tpu.utils import native

    if args.golden is not None:
        if native.native_available():
            vals = native.native_intermediates(args.golden)
        else:
            inter = calc_intermediates_np(np.asarray(args.golden))
            vals = [float(inter[k]) for k in INTER_KEYS]
        for k, v in zip(INTER_KEYS, vals):
            print(f"{k}\t{v:.9g}")
        return 0

    tbl = (native.native_table() if native.native_available()
           else table_ops.build_table(calc_intermediates_np, INTER_KEYS))
    if args.out:
        np.save(args.out, tbl)
        print(f"wrote {tbl.shape} table to {args.out}")
    else:
        for row in tbl:
            print(" ".join(f"{v:.9g}" for v in row))
    return 0


def cmd_replay(args) -> int:
    from fib_tf_tpu.utils.viz import Screen, play_cube

    cube = np.load(args.path)
    im = Screen(cube.shape[1], cube.shape[2], "cube replay")
    play_cube(cube, im=im, fps=args.fps)
    if im.backend_name != "headless":
        im.wait()
    return 0


def cmd_tips(args) -> int:
    """Post-hoc spiral-tip quantification of a saved movie (utils/tips.py;
    the reference judged its spiral runs by eye from Screen frames).  For
    a LIVE count during a run, see `run --rotor`."""
    from fib_tf_tpu.utils.tips import plot_tracks, singularity_count, track_tips

    cube = np.load(args.path)
    tracks = track_tips(cube, tau=args.tau, max_jump=args.max_jump,
                        max_gap=args.max_gap, min_length=args.min_length)
    counts = singularity_count(cube, tau=args.tau)
    if args.json:
        print(json.dumps({
            "frames": int(cube.shape[0]),
            "n_tracks": len(tracks),
            "mean_singularities": float(counts.mean()),
            "max_singularities": int(counts.max()) if len(counts) else 0,
            "tracks": [{
                "charge": tr.charge,
                "length": len(tr),
                "start_frame": tr.frames[0],
                "meander_extent": list(tr.meander_extent()),
            } for tr in tracks[:16]],
        }))
    else:
        print(f"{args.path}: {cube.shape[0]} frames {cube.shape[1]}x"
              f"{cube.shape[2]}, mean rotors/frame {counts.mean():.2f}")
        if not tracks:
            print("no sustained tips (plane wave or quiescent)")
        for i, tr in enumerate(tracks[:8]):
            ey, ex = tr.meander_extent()
            print(f"  tip {i}: charge {tr.charge:+d}, {len(tr)} frames "
                  f"from frame {tr.frames[0]}, meander {ey:.1f}x{ex:.1f} "
                  f"cells around ({np.mean(tr.ys):.0f}, "
                  f"{np.mean(tr.xs):.0f})")
    if args.save_plot:
        plot_tracks(args.save_plot, cube, tracks)
        print(f"saved {args.save_plot}")
    return 0


def cmd_filaments(args) -> int:
    """Scroll-wave filament census of a saved [T, D, H, W] volume movie
    (utils/filaments.py) — the 3D rotor census; no reference equivalent
    (the reference is strictly 2D)."""
    from fib_tf_tpu.utils.filaments import census_movie

    movie = np.load(args.path)
    if movie.ndim != 4 or movie.shape[0] <= args.tau:
        print(f"error: need a [T, D, H, W] movie with T > tau "
              f"(got shape {movie.shape}, tau={args.tau})")
        return 1
    per_t = census_movie(movie, tau=args.tau, link_dist=args.link_dist,
                         min_span=args.min_span)
    counts = [len(fs) for fs in per_t]
    lengths = [sum(f.arc_length for f in fs) for fs in per_t]
    if args.json:
        print(json.dumps({
            "frames": int(movie.shape[0]),
            "depth": int(movie.shape[1]),
            "mean_filaments": float(np.mean(counts)) if counts else 0.0,
            "max_filaments": int(max(counts)) if counts else 0,
            "mean_total_length": float(np.mean(lengths)) if lengths else 0.0,
        }))
    else:
        print(f"{args.path}: {movie.shape[0]} frames, "
              f"{movie.shape[1]} slices of {movie.shape[2]}x{movie.shape[3]}")
        print(f"filaments/frame: mean {np.mean(counts):.2f} "
              f"max {max(counts) if counts else 0}; total arc length/frame: "
              f"mean {np.mean(lengths):.1f} cells")
        peak = int(np.argmax(counts)) if counts else 0
        for f in (per_t[peak] if counts else [])[:8]:
            z0, z1 = int(f.points[0, 0]), int(f.points[-1, 0])
            print(f"  frame {peak + args.tau}: charge {f.charge:+d}, "
                  f"z {z0}-{z1}, arc {f.arc_length:.1f} cells")
    if args.save_plot:
        from fib_tf_tpu.utils.filaments import plot_filaments

        peak = int(np.argmax(counts))
        plot_filaments(args.save_plot, movie[peak + args.tau], per_t[peak])
        print(f"saved {args.save_plot}")
    return 0


def cmd_dfmap(args) -> int:
    """Dominant-frequency mapping of a saved movie (utils/spectral.py) —
    the frequency-domain fibrillation quantification; the reference's
    only rate measurement was cycle length at one probe pixel
    (ionic.py:216-224)."""
    from fib_tf_tpu.utils.spectral import dominant_frequency_map, plot_df_map

    cube = np.load(args.path)
    m = dominant_frequency_map(cube, frame_ms=args.frame_ms,
                               f_min_hz=args.f_min, f_max_hz=args.f_max)
    if args.json:
        print(json.dumps({
            "frames": int(cube.shape[0]),
            "median_df_hz": round(m.median_df(), 3),
            "max_df_hz": float(m.df_hz.max()),
            "median_oi": round(m.median_oi(), 3),
            "active_fraction": round(float(m.active.mean()), 3),
        }))
    else:
        print(f"{args.path}: median DF {m.median_df():.2f} Hz "
              f"(peak {m.df_hz.max():.2f}), median OI {m.median_oi():.2f}, "
              f"{m.active.mean() * 100:.0f}% of pixels active")
    if args.save_plot:
        plot_df_map(args.save_plot, m)
        print(f"saved {args.save_plot}")
    return 0


def cmd_apdmap(args) -> int:
    """Per-pixel APD/alternans maps of a saved movie (utils/apd.py) —
    the spatial alternans quantification (discordant alternans is the
    standard wavebreak precursor); the reference had no per-pixel
    quantification at all."""
    from fib_tf_tpu.utils.apd import apd_map, plot_apd_map

    cube = np.load(args.path)
    if cube.ndim == 4:
        # [T, D, H, W] volume movie: per-cell APD is slice-local, so
        # stack the z-slices vertically (the maps read as D tiles)
        t, d, h, w = cube.shape
        cube = cube.reshape(t, d * h, w)
    r = apd_map(cube, frame_ms=args.frame_ms, level=args.level)
    disc = r.discordance
    if args.json:
        print(json.dumps({
            "frames": int(cube.shape[0]),
            "valid_fraction": round(float(r.valid.mean()), 3),
            "median_apd_ms": None if not r.valid.any() else round(
                float(np.nanmedian(r.apd_last[r.valid])), 2),
            "max_alternans_ms": None if not r.valid.any() else round(
                float(np.nanmax(r.alternans)), 2),
            "median_alternans_ms": None if not r.valid.any() else round(
                float(np.nanmedian(r.alternans[r.valid])), 2),
            "discordance": None if disc is None else round(disc, 3),
            "truncated_fraction": round(r.truncated_fraction, 3),
        }))
    else:
        if r.valid.any():
            print(f"{args.path}: median APD{int(args.level * 100)} "
                  f"{np.nanmedian(r.apd_last[r.valid]):.1f} ms, "
                  f"alternans median "
                  f"{np.nanmedian(r.alternans[r.valid]):.1f} / max "
                  f"{np.nanmax(r.alternans):.1f} ms, "
                  f"{r.valid.mean() * 100:.0f}% of pixels with >= 2 "
                  "beats"
                  + (f", discordance {disc:.2f}" if disc is not None
                     else ""))
        else:
            print(f"{args.path}: no pixel saw two complete beats")
    if args.save_plot:
        plot_apd_map(args.save_plot, r)
        print(f"saved {args.save_plot}")
    return 0


def cmd_s2scan(args) -> int:
    """The vulnerable-window experiment as one batched device program
    (engine/ensemble.s2_scan; the reference needed one process per S2
    time)."""
    from fib_tf_tpu.engine.ensemble import s2_scan

    model_cls = MODEL_REGISTRY[args.model]
    cfg = SimConfig(
        width=args.width, height=args.height, dt=_resolve_dt(args),
        diff=args.diff if args.diff is not None else _default_diff(args.model),
        duration=args.duration,
        ultra_slow=(args.model == "court_ultra"),
    )
    model = model_cls(cfg)
    ms_per_outer = cfg.dt * model.dt_per_step
    s2_ms = np.linspace(args.s2_from, args.s2_to, args.members)
    steps, sustained, _ = s2_scan(
        model,
        int(round(args.duration / ms_per_outer)),
        np.round(s2_ms / ms_per_outer).astype(np.int32),
        s2_loc=args.s2_loc,
    )
    window = s2_ms[sustained]
    if args.json:
        print(json.dumps({
            "model": args.model,
            "s2_ms": [float(t) for t in s2_ms],
            "sustained": [bool(s) for s in sustained],
            "window_ms": ([float(window.min()), float(window.max())]
                          if len(window) else None),
        }))
        return 0
    for t, hit in zip(s2_ms, sustained):
        print(f"S2 @ {t:6.1f} ms -> {'REENTRY' if hit else 'died out'}")
    if len(window):
        print(f"vulnerable window: [{window.min():.1f}, "
              f"{window.max():.1f}] ms")
    else:
        print("no reentry induced in the scanned range")
    return 0


def cmd_volume(args) -> int:
    """3D scroll-wave experiment (engine/volume.run_volume) — the 3D
    generalization of the reference's S1-S2 spiral protocols
    (fenton.py:155-187), which a 2D framework cannot represent."""
    import time

    from fib_tf_tpu.engine.volume import VolumeEvent, run_volume
    from fib_tf_tpu.ops import stencil
    from fib_tf_tpu.utils import viz

    args.dt = _resolve_dt(args, floor=0.05)
    cfg = SimConfig(
        width=args.width, height=args.height, dt=args.dt,
        diff=args.diff if args.diff is not None else _default_diff(args.model),
        duration=args.duration,
        ultra_slow=(args.model == "court_ultra"),
    )
    model = MODEL_REGISTRY[args.model](cfg)
    n_outer = int(args.duration / (model.dt_per_step * args.dt))

    phase = None
    for spec in args.hole:
        parts = spec.split(",")
        x, y, r = float(parts[0]), float(parts[1]), float(parts[2])
        neg = len(parts) > 3 and parts[3] in ("neg", "1", "true")
        phase = stencil.add_hole_to_phase_field(
            phase, args.height, args.width, x, y, r, neg=neg
        )

    events = []
    if args.s2 is not None:
        s2_step = int(args.s2 / (model.dt_per_step * args.dt))
        events.append(VolumeEvent(
            step=s2_step, loc=args.s2_loc,
            z1=max(1, int(round(args.depth * args.s2_z_frac))),
        ))

    frames_every = None
    if args.frames is not None:
        frames_every = max(1, int(args.frames / (model.dt_per_step
                                                 * args.dt)))
    elif args.save_volume or args.save_cube:
        frames_every = max(1, n_outer // 60)

    electrodes = []
    for spec in args.ecg:
        z, y, x = (float(p) for p in spec.split(","))
        electrodes.append((z, y, x))

    t0 = time.perf_counter()
    final, probes, frames = run_volume(
        model, depth=args.depth, n_outer=n_outer, phase=phase,
        dz_ratio=args.dz_ratio,
        fiber_twist=np.deg2rad(args.fiber_twist),
        fiber_ratio=args.fiber_ratio,
        fiber_elevation=np.deg2rad(args.fiber_elevation), events=events,
        frames_every=frames_every, rotor_probe=args.rotor,
        electrodes=electrodes,
    )
    elapsed = time.perf_counter() - t0

    img = (np.asarray(final[model.pot_key]) - model.min_v) / (
        model.max_v - model.min_v
    )
    cells = args.depth * args.height * args.width
    summary = {
        "model": args.model,
        "shape": [args.depth, args.height, args.width],
        "outer_steps": n_outer,
        "elapsed_s": round(elapsed, 3),
        "cell_updates_per_sec": round(
            cells * n_outer * model.dt_per_step / elapsed
        ),
        "final_activity_fraction": round(float((img > 0.1).mean()), 4),
    }
    if args.rotor:
        r = np.asarray(probes["rotors"])
        summary["rotors"] = {
            "mean_count": round(float(r[:, :, 0].sum(axis=1).mean()), 3),
            "max_count": int(r[:, :, 0].sum(axis=1).max()),
            "final_per_slice": [int(c) for c in r[-1, :, 0]],
        }
    if electrodes:
        e = np.asarray(probes["ecg"])
        summary["ecg_p2p"] = [
            round(float(c.max() - c.min()), 4) for c in e.T
        ]
        if args.save_ecg:
            np.save(args.save_ecg, e)
    print(json.dumps(summary))
    if args.save_volume and frames is not None:
        np.save(args.save_volume, frames)
    if args.save_cube and frames is not None:
        viz.save_cube(args.save_cube, frames[:, args.depth // 2])
    return 0


def cmd_restitution(args) -> int:
    """APD-restitution curve as one batched device program
    (engine/restitution.restitution_scan): every S2 coupling interval is
    an ensemble member; APD/DI are extracted host-side from the probe
    streams.  No reference equivalent — its only sweep mechanism was one
    process per run."""
    from fib_tf_tpu.engine.restitution import restitution_scan

    model_cls = MODEL_REGISTRY[args.model]
    cfg = SimConfig(
        width=args.size, height=args.size, dt=_resolve_dt(args),
        diff=args.diff if args.diff is not None else _default_diff(args.model),
        duration=10,
        ultra_slow=(args.model == "court_ultra"),
        g_scale=_parse_gscale(args.gscale),
    )
    if args.cv and args.dynamic:
        raise SystemExit("--cv and --dynamic are separate protocols")
    if args.cv:
        cfg = cfg.replace(width=max(128, args.size), height=8)
    model = model_cls(cfg)
    if args.cv:
        return _cmd_restitution_cv(args, model)
    if args.dynamic:
        return _cmd_restitution_dynamic(args, model)
    coupling = np.linspace(args.ci_from, args.ci_to, args.members)
    r = restitution_scan(
        model, coupling_ms=coupling, bcl_ms=args.bcl, n_s1=args.n_s1,
        tail_ms=max(600.0, args.bcl),
    )
    s = r.slope()
    if args.json:
        print(json.dumps({
            "model": args.model,
            "apd_s1_ms": float(r.apd_s1_ms),
            "coupling_ms": [float(c) for c in r.coupling_ms],
            "di_ms": [None if not np.isfinite(d) else float(d)
                      for d in r.di_ms],
            "apd_ms": [None if not np.isfinite(a) else float(a)
                       for a in r.apd_ms],
            "captured": [bool(c) for c in r.captured],
            "max_slope": None if s is None else float(s),
        }))
        return 0
    print(f"S1 APD90: {r.apd_s1_ms:.1f} ms")
    print(f"{'CI (ms)':>8} {'DI (ms)':>8} {'APD90 (ms)':>10}")
    for ci, di, apd, cap in zip(r.coupling_ms, r.di_ms, r.apd_ms,
                                r.captured):
        if cap:
            print(f"{ci:8.1f} {di:8.1f} {apd:10.1f}")
        else:
            print(f"{ci:8.1f} {'—':>8} {'no capture':>10}")
    if s is not None:
        print(f"max slope dAPD/dDI: {s:.2f}")
    return 0


def _cmd_restitution_cv(args, model) -> int:
    """`restitution --cv`: conduction-velocity restitution on conducting
    strips (engine/restitution.cv_restitution_scan) — the dynamic CV
    curve the reference's static diff_conduction_velcoty.dat
    calibration never measured."""
    from fib_tf_tpu.engine.restitution import cv_restitution_scan

    coupling = np.linspace(args.ci_from, args.ci_to, args.members)
    r = cv_restitution_scan(
        model, coupling_ms=coupling, bcl_ms=args.bcl, n_s1=args.n_s1,
        tail_ms=300.0,
    )
    if args.json:
        print(json.dumps({
            "model": args.model,
            "protocol": "cv",
            "cv_s1": None if not np.isfinite(r.cv_s1) else float(r.cv_s1),
            "coupling_ms": [float(c) for c in r.coupling_ms],
            "di_ms": [None if not np.isfinite(d) else float(d)
                      for d in r.di_ms],
            "cv": [None if not np.isfinite(v) else float(v)
                   for v in r.cv],
            "captured": [bool(c) for c in r.captured],
        }))
        return 0
    print(f"S1 CV: {r.cv_s1:.3f} cells/ms")
    print(f"{'CI (ms)':>8} {'DI (ms)':>8} {'CV (cells/ms)':>13}")
    for ci, di, v, cap in zip(r.coupling_ms, r.di_ms, r.cv, r.captured):
        if cap:
            di_s = f"{di:8.1f}" if np.isfinite(di) else f"{'?':>8}"
            print(f"{ci:8.1f} {di_s} {v:13.3f}")
        else:
            print(f"{ci:8.1f} {'—':>8} {'block':>13}")
    return 0


def _cmd_restitution_dynamic(args, model) -> int:
    """`restitution --dynamic`: steady-state pacing, one BCL per member
    (engine/restitution.dynamic_restitution_scan).  Alternans and 2:1
    block fall out of the last-two-beats readout — the experiment the
    ten Tusscher-Panfilov 2006 breakup analysis is built on."""
    from fib_tf_tpu.engine.restitution import dynamic_restitution_scan

    bcl = np.linspace(args.ci_from, args.ci_to, args.members)
    r = dynamic_restitution_scan(
        model, bcl_ms=bcl, n_beats=args.beats,
        tail_ms=max(500.0, float(bcl.max())),
    )
    s = r.slope()
    if args.json:
        print(json.dumps({
            "model": args.model,
            "protocol": "dynamic",
            "n_beats": int(r.n_beats),
            "bcl_ms": [float(b) for b in r.bcl_ms],
            "di_ms": [None if not np.isfinite(d) else float(d)
                      for d in r.di_ms],
            "apd_ms": [None if not np.isfinite(a) else float(a)
                       for a in r.apd_ms],
            "alternans_ms": [None if not np.isfinite(a) else float(a)
                             for a in r.alternans_ms],
            "captured": [bool(c) for c in r.captured],
            "max_slope": None if s is None else float(s),
        }))
        return 0
    print(f"{'BCL (ms)':>9} {'DI (ms)':>8} {'APD90 (ms)':>10} "
          f"{'alternans':>9}")
    for b, di, apd, alt, cap in zip(r.bcl_ms, r.di_ms, r.apd_ms,
                                    r.alternans_ms, r.captured):
        if cap:
            print(f"{b:9.1f} {di:8.1f} {apd:10.1f} {alt:9.1f}")
        else:
            print(f"{b:9.1f} {'—':>8} {'no 1:1 capture':>10}")
    if s is not None:
        print(f"max dynamic slope dAPD/dDI: {s:.2f}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from fib_tf_tpu.utils import cache

    cache.enable()
    return {
        "run": cmd_run,
        "bench": cmd_bench,
        "table": cmd_table,
        "replay": cmd_replay,
        "tips": cmd_tips,
        "dfmap": cmd_dfmap,
        "apdmap": cmd_apdmap,
        "filaments": cmd_filaments,
        "s2scan": cmd_s2scan,
        "volume": cmd_volume,
        "restitution": cmd_restitution,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
