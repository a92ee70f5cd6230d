#!/usr/bin/env python
"""Smoke run of the simulator on an NVIDIA GPU.

Drives the entry points a user calls — `Simulation(...).define()
.simulate()`, `run_ensemble`, `run_volume` — at realistic sizes,
compares every model family with its golden 0D trace and with the same
program run on the host CPU in this process, and prints one JSON object
as the last line of standard output:

  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

  python chip_smoke.py               # one card: every single-card phase
  python chip_smoke.py --four-cards  # only the sharded paths, on 4 cards

Any failed phase raises, so the exit code is non-zero and no result line
is printed; so does a run where JAX finds no GPU.  Set
JAX_COMPILATION_CACHE_DIR to keep compiled programs between runs (the
cache hits and misses are counted and printed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

# The CPU reference runs in this process beside the GPU: keep the CPU
# backend available when the environment names platforms explicitly.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

# every model family at its own recommended dt (IonicModel.default_dt)
FAMILIES = ("fenton", "br", "court", "court_ultra", "ms", "lr1", "tp06")

# The slowest family conducts about 1.5 cells/ms at its default
# diffusion (br), so a planar S1 wave needs about 370 ms to cross 512
# cells; 450 ms lets every family's wave reach the far edge.
CROSS_MS = 450.0

# GPU vs CPU, same program: float32 ulp differences of exp/expm1 and of
# reduction and fusion order, amplified by the excitable dynamics.  The
# potential may differ by at most 1% of the model's voltage range, and a
# pixel's activation time (first frame above half range) by at most one
# frame interval.
V_TOL_FRAC = 1e-2
ACT_TOL_FRAMES = 1

# Sharded vs one card, same backend: only the halo exchange and XLA's
# fusion of the shard shapes differ; the golden tests' 1e-3 of the range.
SHARD_TOL_FRAC = 1e-3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded paths, on four cards")
    return p.parse_args(argv)


def require_gpu(devices, count: int = 1):
    """The devices, or RuntimeError unless the first `count` are GPUs."""
    if len(devices) < count or any(
            d.platform != "gpu" for d in devices[:count]):
        raise RuntimeError(
            f"need {count} GPU device(s), JAX found "
            f"{[d.platform for d in devices]}")
    return devices[:count]


def result_line(devices) -> str:
    """The last line of standard output."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


@contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"   {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


class CacheCounter:
    """Counts persistent-compile-cache hits and misses (jax.monitoring)."""

    def __init__(self):
        import jax

        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


# -- configurations -------------------------------------------------------


def family_model(name: str, size: int, duration: float, **kw):
    """`name` on a `size`² sheet at its recommended dt and diffusion (BR
    with cheby+skip, the reference's fastest configuration); `kw`
    overrides SimConfig fields."""
    from fib_tf_tpu.cli import _default_diff
    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.models import MODEL_REGISTRY

    cls = MODEL_REGISTRY[name]
    fields = dict(width=size, height=size, dt=cls.default_dt,
                  dt_per_plot=10, diff=_default_diff(name),
                  duration=duration, ultra_slow=(name == "court_ultra"))
    if name == "br":
        fields.update(cheby=True, skip=True)
    fields.update(kw)
    return cls(SimConfig(**fields))


def on_device(dev):
    """Default device for the block: `dev`, or the GPU for None."""
    import jax

    return jax.default_device(dev) if dev is not None else nullcontext()


def timed_simulate(sim, **kw):
    """(result, set-up seconds): set-up is the time simulate() spends
    before its timed region — compiling and warming each chunk."""
    t0 = time.perf_counter()
    res = sim.simulate(**kw)
    return res, time.perf_counter() - t0 - res.elapsed


def far_edge_reached(frames) -> bool:
    """The S1 wave (launched at the left edge) excited the far column."""
    h, w = frames.shape[1:]
    return bool((frames[:, h // 2, w - 3] > 0.5).any())


def report(label, model, res, setup_s):
    sim_s = res.steps * model.dt_per_step * model.cfg.dt / 1000.0
    print(f"   {label}: {res.elapsed / sim_s:.6f} wall-s/sim-s, "
          f"set-up {setup_s:.1f} s, {res.steps} outer steps", flush=True)


# -- phase 2: the main path -----------------------------------------------


def br_spiral():
    """BR cheby+skip at 512², dt 0.1: S1-S2 spiral around a phase-field
    hole (the reference's br.py protocol), 1000 ms, with frames, probes
    and an electrode."""
    from fib_tf_tpu.engine import Simulation

    model = family_model("br", 512, 1000.0)
    sim = Simulation(model)
    sim.add_hole_to_phase_field(150, 200, 40)
    sim.add_electrode(400, 256, 5.0)
    sim.define()
    sim.add_pace_op("s2", "luq", 10.0)
    res, setup = timed_simulate(sim, schedule=[(300.0, "s2")],
                                record_frames_every_ms=10)
    report("br 512 cheby+skip spiral", model, res, setup)
    check(np.isfinite(res.state["V"]).all(), "br spiral: non-finite V")
    check(np.isfinite(res.probes["egm"]).all(), "br spiral: egm")
    check(far_edge_reached(res.frames), "br spiral: S1 never crossed")
    return setup


def br_4096():
    """BR at 4096², about 537 MB of state — past the 50 MB L2."""
    from fib_tf_tpu.engine import Simulation

    model = family_model("br", 4096, 20.0)
    res, setup = timed_simulate(Simulation(model).define())
    report("br 4096", model, res, setup)
    check(np.isfinite(res.state["V"]).all(), "br 4096: non-finite V")
    img = (res.state["V"] - model.min_v) / (model.max_v - model.min_v)
    check(img[img.shape[0] // 2, :40].max() > 0.5,
          "br 4096: no wavefront near the stimulus")


def cli_run():
    """The CLI's `run` command, as a user types it: BR 512², 100 ms,
    with a far-field ECG electrode."""
    import io
    from contextlib import redirect_stdout

    from fib_tf_tpu import cli

    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["run", "--model", "br", "--width", "512",
                       "--height", "512", "--duration", "100", "--skip",
                       "--ecg", "256,256,10"])
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"   cli run br 512: {rec['elapsed_s'] / 0.1:.4f} wall-s/sim-s, "
          f"{rec['outer_steps']} outer steps", flush=True)
    check(rc == 0 and rec["outer_steps"] == 200, "cli run: bad summary")
    check(all(np.isfinite(rec["ecg_p2p"])), "cli run: ECG not finite")


def families_512():
    """Every family, and court with its lookup table, at 512² for
    CROSS_MS: finite, and the S1 wave reached the far edge."""
    from fib_tf_tpu.engine import Simulation

    runs = [(name, {}) for name in FAMILIES] + [("court", {"table": True})]
    for name, kw in runs:
        model = family_model(name, 512, CROSS_MS, **kw)
        res, setup = timed_simulate(Simulation(model).define(),
                                    record_frames_every_ms=10)
        label = name + (" table" if kw else "")
        report(f"{label} 512", model, res, setup)
        check(np.isfinite(res.state[model.pot_key]).all(),
              f"{label}: non-finite potential")
        check(far_edge_reached(res.frames),
              f"{label}: wave did not reach the far edge")


# -- phase 3: the plain reference -----------------------------------------


GOLDENS = (
    # name, family, config overrides, stimulus, outer steps
    # (tests/test_golden.py)
    ("fenton_ap", "fenton", {}, 0.3, 400),
    ("br_direct_ap", "br", dict(cheby=False, skip=False), -30.0, 700),
    ("br_cheby_ap", "br", dict(cheby=True, skip=False), -30.0, 700),
    ("br_cheby_skip_ap", "br", dict(cheby=True, skip=True), -30.0, 700),
    ("court_ap", "court", {}, 20.0, 400),
    ("court_table_ap", "court", dict(table=True), 20.0, 400),
    ("court_ultra_ap", "court_ultra", {}, 20.0, 400),
    ("lr1_ap", "lr1", dict(dt=0.02), -30.0, 2200),
    ("tp06_ap", "tp06", dict(dt=0.02), 20.0, 2000),
    ("tp06_skip_ap", "tp06", dict(dt=0.02, skip=True), 20.0, 2000),
)


def goldens(root: str):
    """0D action potentials on the GPU against tests/golden/, within the
    golden tests' own atol = 1e-3 of the voltage range."""
    import jax
    import jax.numpy as jnp

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.models import MODEL_REGISTRY, cell_geometry

    geom = cell_geometry()
    for name, fam, kw, stim, n in GOLDENS:
        cfg = SimConfig(**{"width": 8, "height": 8, "dt": 0.1,
                           "duration": 1, **kw})
        model = MODEL_REGISTRY[fam](cfg)
        state = model.initial_state(s1=False)
        state[model.pot_key][:] = stim

        def body(s, _, model=model):
            s = model.step(s, geom)
            return s, s[model.pot_key][0, 0]

        st = {k: jnp.asarray(v) for k, v in state.items()}
        _, tr = jax.jit(
            lambda s, body=body, n=n: jax.lax.scan(body, s, None,
                                                  length=n))(st)
        want = np.load(os.path.join(root, "tests", "golden", f"{name}.npy"))
        scale = model.max_v - model.min_v
        err = float(np.abs(np.asarray(tr) - want).max()) / scale
        print(f"   golden {name}: max |dV| = {err:.3e} of range", flush=True)
        check(err <= 1e-3, f"golden {name}: {err:.3e} > 1e-3 of range")


def activation_frames(frames):
    """Per pixel, the first frame index above half range (the frame
    count where it never activates)."""
    above = frames > 0.5
    return np.where(above.any(axis=0), np.argmax(above, axis=0),
                    len(frames))


def compare_runs(label, model, gpu, cpu, frame_ms):
    """Print and bound max |dV| and the activation-time difference."""
    scale = model.max_v - model.min_v
    dv = float(np.abs(gpu.state[model.pot_key]
                      - cpu.state[model.pot_key]).max())
    ag, ac = activation_frames(gpu.frames), activation_frames(cpu.frames)
    dact = int(np.abs(ag - ac).max())
    print(f"   {label} 128 gpu vs cpu: max |dV| = {dv:.3e} "
          f"({dv / scale:.2e} of range), max activation-time difference "
          f"= {dact * frame_ms:g} ms", flush=True)
    check(dv <= V_TOL_FRAC * scale, f"{label}: |dV| {dv} past tolerance")
    check(dact <= ACT_TOL_FRAMES, f"{label}: activation times differ")


def gpu_vs_cpu_families(cpu):
    """Each family on a 128² sheet, edge stimulus, 50 ms, against the
    same program on the host CPU."""
    from fib_tf_tpu.engine import Simulation

    for name in FAMILIES:
        out = {}
        for dev in ("gpu", "cpu"):
            model = family_model(name, 128, 50.0)
            with on_device(cpu if dev == "cpu" else None):
                out[dev] = Simulation(model).define().simulate(
                    record_frames_every_ms=1.0)
            check(np.isfinite(out[dev].state[model.pot_key]).all(),
                  f"{name} {dev}: non-finite potential")
        compare_runs(name, model, out["gpu"], out["cpu"], 1.0)


# -- phase 4: ensemble and volume -----------------------------------------


def ensemble_scan(cpu):
    """run_ensemble: fenton, 16 members x 128², an S2 scan (S2 at 1..16
    ms, one per member), 20 ms."""
    from fib_tf_tpu.engine.ensemble import (
        EnsembleEvent, run_ensemble, stack_states,
    )

    model = family_model("fenton", 128, 20.0)
    stacked = stack_states([model.initial_state(s1=True)] * 16)
    ev = EnsembleEvent(step=np.arange(1, 17, dtype=np.int32), loc="luq")
    out = {}
    for dev in ("gpu", "cpu"):
        with on_device(cpu if dev == "cpu" else None):
            t0 = time.perf_counter()
            out[dev] = run_ensemble(model, stacked, 20, events=[ev])
        print(f"   ensemble {dev}: {time.perf_counter() - t0:.1f} s "
              "(compile included)", flush=True)
        check(np.isfinite(out[dev][0]["u"]).all(), f"ensemble {dev}")
    du = float(np.abs(out["gpu"][0]["u"] - out["cpu"][0]["u"]).max())
    dp = float(np.abs(out["gpu"][1] - out["cpu"][1]).max())
    print(f"   ensemble gpu vs cpu: max |du| = {du:.3e}, max |d probe| = "
          f"{dp:.3e}", flush=True)
    check(du <= V_TOL_FRAC and dp <= V_TOL_FRAC, "ensemble: gpu != cpu")


def volume_scroll(cpu):
    """run_volume: fenton 16x128x512 scroll-wave set-up (cross-field S2
    over half the depth) with the rotor census and an ECG electrode,
    20 ms."""
    from fib_tf_tpu.engine.volume import VolumeEvent, run_volume

    # dt 0.05: the isotropic 3D explicit limit at diff 1.5 is 0.083 ms
    model = family_model("fenton", 128, 20.0, width=512, dt=0.05)
    n_outer = 40   # 20 ms at 0.5 ms per outer step
    kw = dict(depth=16, n_outer=n_outer, rotor_probe=True,
              electrodes=[(-5.0, 64.0, 256.0)],
              events=[VolumeEvent(step=10, loc="luq", z1=8)])
    out = {}
    for dev in ("gpu", "cpu"):
        with on_device(cpu if dev == "cpu" else None):
            t0 = time.perf_counter()
            out[dev] = run_volume(model, **kw)
        print(f"   volume {dev}: {time.perf_counter() - t0:.1f} s "
              "(compile included)", flush=True)
        final, probes, _ = out[dev]
        check(np.isfinite(final["u"]).all(), f"volume {dev}: u")
        check(np.isfinite(probes["ecg"]).all(), f"volume {dev}: ecg")
    (fg, pg, _), (fc, pc, _) = out["gpu"], out["cpu"]
    du = float(np.abs(fg["u"] - fc["u"]).max())
    decg = float(np.abs(pg["ecg"] - pc["ecg"]).max()
                 / max(np.abs(pc["ecg"]).max(), 1e-12))
    drot = float(np.abs(pg["rotors"] - pc["rotors"]).max())
    print(f"   volume gpu vs cpu: max |du| = {du:.3e}, ECG max relative "
          f"difference = {decg:.3e}, rotor census max difference = "
          f"{drot:g}", flush=True)
    check(du <= V_TOL_FRAC, "volume: gpu != cpu")
    check(decg <= V_TOL_FRAC, "volume: ECG gpu != cpu")


# -- phase 5: four cards --------------------------------------------------


def four_cards(devices):
    """BR 4096² over a (4,) mesh — shard_map wide halo and GSPMD — and a
    (2, 2) mesh; a member-sharded ensemble; a z-sharded volume.  Each
    against the same run on one card."""
    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.engine.ensemble import (
        EnsembleEvent, run_ensemble, stack_states,
    )
    from fib_tf_tpu.engine.volume import run_volume
    from fib_tf_tpu.parallel import make_mesh

    def on_four(sim):
        # where the sharded initial state lands (Simulation places it
        # with its own sharding)
        st = sim._device_state()
        devs = {s.device for s in st[sim.model.pot_key].addressable_shards}
        check(len(devs) == 4, f"state on {len(devs)} devices, not 4")

    ref_model = family_model("br", 4096, 20.0)
    ref = Simulation(ref_model).define().simulate()
    scale = ref_model.max_v - ref_model.min_v
    for label, kw in (("mesh (4,) auto", dict(mesh_shape=(4,))),
                      ("mesh (4,) gspmd", dict(mesh_shape=(4,),
                                               mesh_mode="gspmd")),
                      ("mesh (2,2) auto", dict(mesh_shape=(2, 2)))):
        model = family_model("br", 4096, 20.0, **kw)
        sim = Simulation(model).define()
        on_four(sim)
        res, setup = timed_simulate(sim)
        report(f"br 4096 {label}", model, res, setup)
        dv = float(np.abs(res.state["V"] - ref.state["V"]).max())
        print(f"   br 4096 {label} vs one card: max |dV| = {dv:.3e} "
              f"({dv / scale:.2e} of range)", flush=True)
        check(dv <= SHARD_TOL_FRAC * scale, f"{label}: sharded != one card")

    mesh = make_mesh(shape=(4,), devices=devices)
    model = family_model("fenton", 128, 20.0)
    stacked = stack_states([model.initial_state(s1=True)] * 16)
    ev = EnsembleEvent(step=np.arange(1, 17, dtype=np.int32), loc="luq")
    one = run_ensemble(model, stacked, 20, events=[ev])
    four = run_ensemble(model, stacked, 20, events=[ev], mesh=mesh)
    du = float(np.abs(one[0]["u"] - four[0]["u"]).max())
    print(f"   ensemble 4-way vs one card: max |du| = {du:.3e}", flush=True)
    check(du <= SHARD_TOL_FRAC, "ensemble: sharded != one card")

    vmodel = family_model("fenton", 128, 20.0, width=512, dt=0.05)
    # wide_halo needs >= dt_per_step (10) slices per shard
    kw = dict(depth=40, n_outer=40, electrodes=[(-5.0, 64.0, 256.0)])
    v1, p1, _ = run_volume(vmodel, **kw)
    v4, p4, _ = run_volume(vmodel, mesh=mesh, wide_halo=True, **kw)
    du = float(np.abs(v1["u"] - v4["u"]).max())
    decg = float(np.abs(p1["ecg"] - p4["ecg"]).max()
                 / max(np.abs(p1["ecg"]).max(), 1e-12))
    print(f"   volume z-sharded vs one card: max |du| = {du:.3e}, ECG "
          f"relative difference = {decg:.3e}", flush=True)
    check(du <= SHARD_TOL_FRAC and decg <= SHARD_TOL_FRAC,
          "volume: sharded != one card")


def main(argv=None) -> int:
    args = parse_args(argv)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import jax

    count = 4 if args.four_cards else 1
    devices = require_gpu(jax.devices(), count)
    import fib_tf_tpu  # noqa: F401  (fails where only this file exists)
    from fib_tf_tpu.utils import cache

    cache.enable()
    counter = CacheCounter()
    card = card_info()
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    if args.four_cards:
        with phase("four cards"):
            four_cards(devices)
    else:
        with phase("main path"):
            setup = br_spiral()
            cli_run()
            br_4096()
            families_512()
        with phase("plain reference"):
            goldens(root)
            gpu_vs_cpu_families(cpu)
        with phase("ensemble and volume"):
            ensemble_scan(cpu)
            volume_scroll(cpu)
        print(f"   br spiral set-up (compile) {setup:.1f} s", flush=True)
    print(f"compile cache: {counter.hits} hits, {counter.misses} misses; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
