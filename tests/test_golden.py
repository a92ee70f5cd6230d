"""Golden-trace regression tests: 0D action potentials must reproduce the
pinned traces in tests/golden/ to 1e-3 relative tolerance (SURVEY.md §4b;
the reference's trace-fidelity requirement applied as a regression pin).

Regenerate deliberately with tools/make_goldens.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import (
    BeelerReuter,
    Courtemanche,
    CourtemancheUltra,
    Fenton4v,
    LuoRudy91,
    TenTusscher06,
    cell_geometry,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG = SimConfig(width=8, height=8, dt=0.1, duration=1)


def trace_cell(model, stim, n_outer):
    geom = cell_geometry()
    state = model.initial_state(s1=False)
    state[model.pot_key][:] = stim

    def body(s, _):
        s = model.step(s, geom)
        return s, s[model.pot_key][0, 0]

    state = {k: jnp.asarray(v) for k, v in state.items()}
    _, tr = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n_outer)
    )(state)
    return np.asarray(tr)


def check(name, model, stim, n, v_scale):
    want = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    got = trace_cell(model, stim, n)
    # relative to the model's voltage range (an absolute mV criterion;
    # pure relative tolerance blows up where V crosses zero)
    np.testing.assert_allclose(got, want, atol=1e-3 * v_scale, rtol=0)


def test_golden_tissue():
    """End-to-end tissue golden: 32x32 Fenton with a phase-field hole,
    S1 stripe, S2 quadrant fire at 4 ms, 8 ms total — pins the stencil +
    boundary + phase-field + event pipeline, not just the 0D reaction."""
    from fib_tf_tpu.engine import Simulation

    cfg = SimConfig(width=32, height=32, dt=0.1, dt_per_plot=10,
                    diff=1.5, duration=8)
    sim = Simulation(Fenton4v(cfg))
    sim.add_hole_to_phase_field(16, 16, 5)
    sim.define()
    sim.add_pace_op("s2", "luq", 1.0)
    res = sim.simulate(schedule=[(4, "s2")])
    want = np.load(os.path.join(GOLDEN, "fenton_tissue_u.npy"))
    np.testing.assert_allclose(res.state["u"], want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,factory,stim,n", [
    ("fenton_ap", lambda: Fenton4v(CFG), 0.3, 400),
    ("br_direct_ap", lambda: BeelerReuter(CFG.replace(cheby=False)), -30.0, 700),
    ("br_cheby_ap", lambda: BeelerReuter(CFG.replace(cheby=True)), -30.0, 700),
    ("br_cheby_skip_ap",
     lambda: BeelerReuter(CFG.replace(cheby=True, skip=True)), -30.0, 700),
    ("court_ap", lambda: Courtemanche(CFG), 20.0, 400),
    ("court_table_ap",
     lambda: Courtemanche(CFG.replace(table=True)), 20.0, 400),
    ("court_ultra_ap", lambda: CourtemancheUltra(CFG), 20.0, 400),
    ("lr1_ap", lambda: LuoRudy91(CFG.replace(dt=0.02)), -30.0, 2200),
    ("tp06_ap", lambda: TenTusscher06(CFG.replace(dt=0.02)), 20.0, 2000),
    ("tp06_skip_ap",
     lambda: TenTusscher06(CFG.replace(dt=0.02, skip=True)), 20.0, 2000),
])
def test_golden_trace(name, factory, stim, n):
    model = factory()
    v_scale = model.max_v - model.min_v
    check(name, model, stim, n, v_scale)
