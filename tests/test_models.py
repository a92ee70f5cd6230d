"""Single-cell (0D) action-potential tests and variant-consistency checks
for the model zoo — the test strategy SURVEY.md §4 prescribes for the
rebuild (the reference itself had no automated tests)."""

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
    cell_geometry,
)

CELL_CFG = SimConfig(width=8, height=8, dt=0.1, duration=10)


def run_cell(model, state, n_outer, record="V"):
    """Scan a 0D model n_outer outer steps, recording one state plane."""
    geom = cell_geometry()

    def body(s, _):
        s = model.step(s, geom)
        return s, s[record][0, 0]

    state = {k: jnp.asarray(v) for k, v in state.items()}
    final, trace = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n_outer)
    )(state)
    return jax.device_get(final), np.asarray(trace)


class TestFenton0D:
    def test_action_potential(self):
        model = Fenton4v(CELL_CFG)
        state = model.initial_state(s1=False)
        state["u"][:] = 0.3  # suprathreshold stimulus (u_c = 0.23)
        final, trace = run_cell(model, state, 400, record="u")
        assert np.isfinite(trace).all()
        assert trace.max() > 0.9         # full depolarization
        assert trace[-1] < 0.1           # repolarized by 400 ms
        # the upstroke is fast (peak within the first few ms), the
        # repolarization slow
        peak = trace.argmax()
        assert peak < 50
        assert trace[peak] - trace[300] > 0.8

    def test_rest_stays_near_rest(self):
        # (0,1,1,0) is not an exact equilibrium: s relaxes to
        # s_inf(0) = 0.5*(1+tanh(-2.4)) ~ 0.008, pulling u up to ~0.008 —
        # far below threshold; no AP fires.
        model = Fenton4v(CELL_CFG)
        state = model.initial_state(s1=False)
        final, trace = run_cell(model, state, 50, record="u")
        assert np.abs(trace).max() < 0.02


class TestBeelerReuter0D:
    def make(self, **kw):
        return BeelerReuter(CELL_CFG.replace(**kw))

    def stimulated_state(self, model):
        state = model.initial_state(s1=False)
        state["V"][:] = -30.0
        return state

    @pytest.mark.parametrize("cheby", [False, True])
    def test_action_potential(self, cheby):
        model = self.make(cheby=cheby)
        state = self.stimulated_state(model)
        final, trace = run_cell(model, state, 800)   # 400 ms
        assert np.isfinite(trace).all()
        assert trace.max() > 5.0       # overshoot above 0 mV
        assert trace[-1] < -75.0       # repolarized
        assert abs(trace[-1] - (-84.6)) < 10.0   # back near resting depol

    def test_cheby_matches_direct(self):
        s0 = None
        traces = {}
        for cheby in (False, True):
            model = self.make(cheby=cheby)
            state = self.stimulated_state(model)
            _, traces[cheby] = run_cell(model, state, 700)
        # AP morphology must agree closely (deg-8 fit error is small)
        assert abs(traces[True].max() - traces[False].max()) < 2.0
        assert abs(traces[True][-1] - traces[False][-1]) < 2.0
        # pointwise agreement away from the steep upstroke
        diff = np.abs(traces[True] - traces[False])
        assert np.median(diff) < 1.0

    def test_skip_matches_full_rate(self):
        traces = {}
        for skip in (False, True):
            model = self.make(cheby=False, skip=skip)
            state = self.stimulated_state(model)
            _, traces[skip] = run_cell(model, state, 700)
        assert abs(traces[True].max() - traces[False].max()) < 3.0
        assert abs(traces[True][-1] - traces[False][-1]) < 3.0

    def test_v_clip(self):
        # V is hard-clipped to [-85, 25] every substep (br.py:167-168)
        model = self.make(cheby=False)
        state = model.initial_state(s1=False)
        state["V"][:] = 100.0  # absurd over-voltage
        final, trace = run_cell(model, state, 5)
        assert trace.max() <= 25.0 + 1e-4


class TestCourtemanche0D:
    def make(self, **kw):
        return Courtemanche(CELL_CFG.replace(**kw))

    def stimulated_state(self, model):
        state = model.initial_state(s1=False)
        state["V"][:] = 20.0   # S1 amplitude (court.py:80-82)
        return state

    def test_action_potential(self):
        model = self.make()
        state = self.stimulated_state(model)
        final, trace = run_cell(model, state, 400)  # 400 ms (outer = 1 ms)
        assert np.isfinite(trace).all()
        assert trace[0] > 0.0          # still depolarized right after stim
        assert trace[-1] < -60.0       # repolarized (chronic AF shortens APD)

    def test_gates_stay_bounded(self):
        model = self.make()
        state = self.stimulated_state(model)
        final, _ = run_cell(model, state, 200)
        for g in ("m", "h", "j", "oa", "oi", "ua", "ui", "xr", "xs",
                  "d", "f", "f_Ca", "u_gate", "v_gate", "w_gate"):
            assert final[g].min() >= 1e-5 - 1e-7, g
            assert final[g].max() <= 0.99999 + 1e-7, g

    def test_table_matches_direct(self):
        traces = {}
        for table in (False, True):
            model = self.make(table=table)
            state = self.stimulated_state(model)
            _, traces[table] = run_cell(model, state, 300)
        # 1 mV-resolution rates: morphology agrees, not bitwise
        assert abs(traces[True].max() - traces[False].max()) < 5.0
        assert abs(traces[True][-1] - traces[False][-1]) < 5.0

    def test_hybrid_cheby_matches_direct(self):
        """The opt-in hybrid Chebyshev path (smooth intermediates fit,
        branchy h/j direct) must track the direct rates closely."""
        traces = {}
        for court_cheby in (False, True):
            model = self.make(court_cheby=court_cheby)
            state = self.stimulated_state(model)
            _, traces[court_cheby] = run_cell(model, state, 300)
        assert np.abs(traces[True] - traces[False]).max() < 1.5

    def test_chronic_shortens_apd(self):
        apd = {}
        for chronic in (False, True):
            model = self.make(chronic=chronic)
            state = self.stimulated_state(model)
            _, trace = run_cell(model, state, 400)
            # crude APD: last step above -60 mV
            above = np.where(trace > -60.0)[0]
            apd[chronic] = above[-1] if len(above) else 0
        assert apd[True] < apd[False]

    def test_ultra_observables(self):
        import jax

        model = CourtemancheUltra(CELL_CFG)
        state = {k: jnp.asarray(v)
                 for k, v in model.initial_state(s1=False).items()}
        vec = jax.jit(model.ultra_observables)(state)
        obs = dict(zip(model.ULTRA_KEYS, np.asarray(vec)))
        assert float(obs["mean_na"]) == pytest.approx(11.17, abs=0.01)
        assert float(obs["mean_us"]) == pytest.approx(0.72, abs=0.01)
        # at rest (-81.18 mV) the us gate's steady state sits high
        assert 0.5 < float(obs["mean_us_infinity"]) <= 1.0
        assert float(obs["mean_tau_us"]) > 0.0

    def test_ultra_slow_gate(self):
        model = CourtemancheUltra(CELL_CFG)
        state = model.initial_state(s1=False)
        assert "us" in state
        state["V"][:] = 20.0
        final, trace = run_cell(model, state, 200)
        assert np.isfinite(trace).all()
        # the us gate must stay in (0, 1) and move from its 0.72 start
        assert 1e-5 <= final["us"].min() and final["us"].max() <= 0.99999


class TestCourtDvMax:
    """Opt-in |dV|/substep cap (SimConfig.dv_max) — the court analog of
    BR's reference V-clip, for long fibrillatory runs that hit genuine
    explicit-Euler stiffness."""

    def test_caps_extreme_excursions(self):
        from fib_tf_tpu.models import Courtemanche, cell_geometry

        def one_step(dv_max):
            # a deliberately unstable configuration (dt far past the
            # explicit-Euler limit) makes one substep overshoot wildly —
            # the mechanical stand-in for the slow blowup of long
            # fibrillatory runs
            cfg = SimConfig(width=8, height=8, dt=50.0, duration=100,
                            dv_max=dv_max)
            m = Courtemanche(cfg)
            st = m.initial_state(s1=False)
            st["V"][:] = 150.0  # far outside physiological range
            geom = cell_geometry()
            s = {k: jnp.asarray(v) for k, v in st.items()}
            out = m.solve(s, geom)
            return float(out["V"][0, 0]) - 150.0

        unclamped = one_step(None)
        clamped = one_step(25.0)
        assert abs(unclamped) > 25.0      # the excursion is genuinely wild
        assert abs(clamped) <= 25.0 + 1e-4

    def test_off_by_default_is_reference_exact(self):
        from fib_tf_tpu.models import Courtemanche, cell_geometry

        cfg = SimConfig(width=8, height=8, dt=0.1, duration=1)
        m = Courtemanche(cfg)
        st = {k: jnp.asarray(v)
              for k, v in m.initial_state(s1=False).items()}
        geom = cell_geometry()
        a = m.solve(st, geom)
        m2 = Courtemanche(cfg.replace(dv_max=1000.0))
        b = m2.solve(st, geom)
        # a generous cap never engages at rest: bit-identical V
        np.testing.assert_array_equal(np.asarray(a["V"]),
                                      np.asarray(b["V"]))


class TestStepFori:
    """`step(unroll=False)` (the identical substeps under lax.fori_loop,
    models/base.repeat_substeps) is value-identical to the unrolled
    step at float32 ULP level."""

    @pytest.mark.parametrize("model_cls,extra", [
        (Fenton4v, {}),
        (BeelerReuter, {"cheby": True, "skip": True}),
        (BeelerReuter, {"cheby": False, "skip": False}),
        (Courtemanche, {}),
    ])
    def test_matches_unrolled(self, model_cls, extra):
        from fib_tf_tpu.models import grid_geometry

        model = model_cls(SimConfig(width=32, height=32, dt=0.1,
                                    diff=1.5, duration=1, **extra))
        geom = grid_geometry()
        a = b = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        for _ in range(3):
            a = jax.jit(lambda s: model.step(s, geom))(a)
            b = jax.jit(lambda s: model.step(s, geom, unroll=False))(b)
        for k in a:
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]),
                rtol=1e-5, atol=1e-7, err_msg=k,
            )
