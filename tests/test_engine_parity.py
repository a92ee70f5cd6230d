"""The engine's compiled paths against the plain model step.

`Simulation.simulate` (a jitted `lax.scan` over outer steps, with probes
and a finiteness check riding along) must reproduce a Python loop of
jitted `model.step` calls, for every model family and every geometry the
step takes: plain, a phase-field hole, a fiber tensor, a diffusion map
and an unaligned grid.  `run_ensemble` (the vmapped scan with in-scan
per-member events) must reproduce the members run one by one.  Both
sides trace the same arithmetic; only XLA's fusion of the scan body
differs, hence the float32-rounding tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.engine.ensemble import (
    EnsembleEvent, run_ensemble, stack_states,
)
from fib_tf_tpu.models import MODEL_REGISTRY, grid_geometry
from fib_tf_tpu.ops import stencil

# family -> SimConfig overrides (each at its recommended dt)
FAMILIES = {
    "fenton": dict(diff=1.5),
    "br": dict(diff=0.809, cheby=True, skip=True),
    "court": dict(diff=0.809),
    "court_ultra": dict(diff=1.5, ultra_slow=True),
    "ms": dict(diff=1.5),
    "lr1": dict(dt=0.02, diff=0.809, skip=True),
    "tp06": dict(dt=0.02, diff=0.809, skip=True),
}

# unaligned (height, width) per family: odd sizes, no power-of-two edge
UNALIGNED = {
    "fenton": (33, 50), "br": (30, 40), "court": (20, 36),
    "court_ultra": (27, 22), "ms": (33, 50), "lr1": (30, 40),
    "tp06": (20, 36),
}

GEOMETRIES = ("plain", "hole", "fiber", "dmap", "unaligned")


def _config(name, geometry, n_outer=3):
    h, w = UNALIGNED[name] if geometry == "unaligned" else (32, 32)
    kw = dict(FAMILIES[name])
    dt = kw.pop("dt", 0.1)
    cls = MODEL_REGISTRY[name]
    if geometry == "fiber":
        kw.update(fiber_angle=0.5, fiber_ratio=0.3)
    return SimConfig(width=w, height=h, dt=dt,
                     duration=n_outer * cls.dt_per_step * dt,
                     dt_per_plot=2 * cls.dt_per_step, **kw)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_simulate_matches_model_step(name, geometry):
    cfg = _config(name, geometry)
    model = MODEL_REGISTRY[name](cfg)
    h, w = cfg.height, cfg.width
    sim = Simulation(model)
    phase = dmap = None
    if geometry == "hole":
        sim.add_hole_to_phase_field(w // 2, h // 2, 5)
        phase = sim.phase
    if geometry == "dmap":
        dmap = stencil.fibrosis_map(h, w, density=0.3, strength=0.6,
                                    seed=2, patch=2)
        sim.set_diffusion_map(dmap)
    res = sim.define().simulate()

    geom = grid_geometry(phase, cfg.fiber_angle, cfg.fiber_ratio,
                         dmap=dmap)
    step = jax.jit(lambda s: model.step(s, geom))
    state = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
    probes = []
    for _ in range(cfg.samples(model.dt_per_step)):
        state = step(state)
        probes.append(float(model.probe(state))
                      * (float(phase[model.probe_pixel]) if phase is not None
                         else 1.0))
    assert res.steps == len(probes)
    scale = model.max_v - model.min_v
    for k in state:
        assert res.state[k].shape == (h, w), k
        np.testing.assert_allclose(res.state[k], np.asarray(state[k]),
                                   rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)
    np.testing.assert_allclose(res.probes["v"], probes, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_run_ensemble_matches_members(name):
    """Three members — S1 wave, resting, resting + an in-scan S2 at a
    per-member step — each against its own loop of model.step."""
    cfg = _config(name, "plain", n_outer=4)
    model = MODEL_REGISTRY[name](cfg)
    members = [model.initial_state(s1=True), model.initial_state(s1=False),
               model.initial_state(s1=False)]
    s2 = np.array([99, 99, 1], np.int32)
    ev = EnsembleEvent(step=s2, loc="luq")
    n = 4
    final, probes = run_ensemble(model, stack_states(members), n,
                                 events=[ev])

    geom = grid_geometry()
    step = jax.jit(lambda s: model.step(s, geom))
    mask = jnp.asarray(ev.resolve_mask(model))
    scale = model.max_v - model.min_v
    for i, init in enumerate(members):
        st = {k: jnp.asarray(v) for k, v in init.items()}
        want_p = []
        for t in range(n):
            st = step(st)
            if t == s2[i]:
                st = {**st, model.pot_key: stencil.apply_pace(
                    st[model.pot_key], mask)}
            want_p.append(float(model.probe(st)))
        for k in st:
            np.testing.assert_allclose(final[k][i], np.asarray(st[k]),
                                       rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"member {i} {k}")
        np.testing.assert_allclose(probes[i], want_p, rtol=1e-5,
                                   atol=1e-5)
