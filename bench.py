"""Headline benchmark: Beeler-Reuter, 512x512, dt=0.1 ms, cheby+skip —
the reference's best published configuration (details.md Table 1:
3.9 wall-s per simulated second on a GTX-1080).

Runs on the GPU that `jax.devices()` provides and exits non-zero when
there is none.  Prints the device on one line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "spread", "samples",
 "platform", "device_kind", "device_count"}
  value       = MEDIAN wall-seconds per simulated second over the
                repeated runs (lower is better)
  spread      = [min, max] across the runs
  vs_baseline = 3.9 / value  (speedup over the reference's best GPU
                number)

Compile time is excluded (the engine compiles and warms its chunks
before its timed region; later runs reuse the same executable).

  python bench.py [SIM_MS] [N_RUNS]
"""

import json
import statistics
import sys

REFERENCE_BEST_S_PER_SIM_S = 3.9   # BR cheby+skip on a GTX-1080
N_RUNS = 5


def main():
    import jax

    dev = jax.devices()[0]
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"device_count={len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX found none")

    from fib_tf_tpu.config import SimConfig
    from fib_tf_tpu.engine import Simulation
    from fib_tf_tpu.models import BeelerReuter

    sim_ms = float(sys.argv[1]) if len(sys.argv) > 1 else 20000.0
    n_runs = int(sys.argv[2]) if len(sys.argv) > 2 else N_RUNS
    cfg = SimConfig(
        width=512, height=512, dt=0.1, dt_per_plot=10, diff=0.809,
        duration=sim_ms, cheby=True, skip=True,
    )
    sim = Simulation(BeelerReuter(cfg)).define()
    samples = []
    for _ in range(n_runs):
        res = sim.simulate(check_finite=False)
        samples.append(res.elapsed / (sim_ms / 1000.0))

    value = statistics.median(samples)
    print(json.dumps({
        "metric": "beeler_reuter_512x512_cheby_skip_wall_s_per_sim_s",
        "value": round(value, 6),
        "unit": "wall_s_per_sim_s",
        "vs_baseline": round(REFERENCE_BEST_S_PER_SIM_S / value, 2),
        "spread": [round(min(samples), 6), round(max(samples), 6)],
        "samples": n_runs,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
