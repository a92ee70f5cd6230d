"""Luo-Rudy 1991 model (models/luo_rudy.py — zoo extension, no reference
counterpart).

Published-physiology pins against Luo & Rudy 1991 (Circ Res 68:1501):
resting potential -84.5 mV, max upstroke velocity ~390-400 V/s (their
normal-[K]o cell), APD ~366 ms — plus the machinery the stiff model
uniquely exercises: the dt stability guard, the adaptive-dt rescue, and
the removable singularities of alpha_m (V = -47.13) and Xi (V = -77).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import LuoRudy91, cell_geometry
from fib_tf_tpu.models.luo_rudy import gate_rates, k1_inf, xi_factor


# long tail: excluded from the smoke tier (pytest -m 'not slow')
pytestmark = pytest.mark.slow

GEOM = cell_geometry()
CFG = SimConfig(width=4, height=4, dt=0.02, duration=10)


def _scan_trace(step_fn, state, n):
    state = {k: jnp.asarray(v) for k, v in state.items()}

    def body(s, _):
        s = step_fn(s)
        return s, s["V"][0, 0]

    final, tr = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n)
    )(state)
    return jax.device_get(final), np.asarray(tr)


@pytest.fixture(scope="module")
def lr1_ap():
    """Quiesce 2 s from the paper's initial conditions, then a -50 mV
    suprathreshold jump (Na gates still at rest), sampled per SUBSTEP
    (0.02 ms) so dV/dt_max is resolved."""
    model = LuoRudy91(CFG)
    quiet, tr_q = _scan_trace(
        lambda s: model.step(s, GEOM), model.initial_state(s1=False),
        10000)  # 0.2 ms per outer step
    rest = float(tr_q[-1])
    stim = {k: np.array(v) for k, v in quiet.items()}
    stim["V"] = np.full_like(stim["V"], -50.0)
    _, tr = _scan_trace(lambda s: model.solve(s, GEOM), stim, 25000)
    return rest, tr


class TestLuoRudy1991:
    def test_resting_potential(self, lr1_ap):
        rest, _ = lr1_ap
        # paper: -84.5 mV rest; must hold it (no drift) after 2 s
        assert rest == pytest.approx(-84.5, abs=1.0)

    def test_max_upstroke(self, lr1_ap):
        _, tr = lr1_ap
        # paper: ~390-400 V/s at normal [K]o (measured 404 from the
        # -50 mV jump at dt=0.02)
        dvdt = np.diff(tr[:5000]) / 0.02  # mV/ms == V/s
        assert float(dvdt.max()) == pytest.approx(400.0, rel=0.10)

    def test_ap_peak(self, lr1_ap):
        _, tr = lr1_ap
        # overshoot to ~+44 mV -> ~129 mV amplitude
        assert float(tr.max()) == pytest.approx(44.4, abs=3.0)

    def test_apd90(self, lr1_ap):
        rest, tr = lr1_ap
        peak = tr.max()
        thr = peak - 0.9 * (peak - rest)
        i_peak = int(tr.argmax())
        up = np.where(tr >= thr)[0][0]
        below = np.where(tr[i_peak:] < thr)[0]
        assert len(below), "AP did not repolarize"
        apd = (i_peak + below[0] - up) * 0.02
        # paper: ~366 ms
        assert apd == pytest.approx(366.0, rel=0.05)

    def test_initial_gates_are_steady_states(self):
        st = LuoRudy91(CFG).initial_state(s1=False)
        rates = gate_rates(np.float64(-84.5), xp=np)
        for g, (a, b) in rates.items():
            np.testing.assert_allclose(
                st[g][0, 0], a / (a + b), rtol=1e-5
            )


class TestStiffnessMachinery:
    def test_dt_guard_rejects_reference_dt(self):
        with pytest.raises(ValueError, match="adaptive_dv"):
            LuoRudy91(SimConfig(width=4, height=4, dt=0.1))

    def test_adaptive_dv_rescues_dt_0p1(self):
        """At dt=0.1 (5x the stable dt) the step-doubling integrator
        refines the upstroke substeps and produces a clean AP."""
        cfg = SimConfig(width=4, height=4, dt=0.1,
                        adaptive_dv=5.0, adaptive_depth=3)
        model = LuoRudy91(cfg)
        st = model.initial_state(s1=False)
        st["V"][:] = -50.0
        _, tr = _scan_trace(lambda s: model.step(s, GEOM), st, 500)
        assert np.isfinite(tr).all()
        assert float(tr.max()) == pytest.approx(44.4, abs=4.0)
        assert tr[-1] < -70.0  # repolarized

    def test_singularities_are_removable(self):
        """alpha_m at V = -47.13 and Xi at V = -77 evaluate to their
        analytic limits, not NaN, when a lane lands exactly on them."""
        v = jnp.asarray([-47.13, -77.0, -40.0, -84.5, 20.0], jnp.float32)
        a_m, _ = gate_rates(v)["m"]
        xi = xi_factor(v)
        assert np.isfinite(np.asarray(a_m)).all()
        assert np.isfinite(np.asarray(xi)).all()
        assert float(a_m[0]) == pytest.approx(3.2, rel=1e-3)
        lim = 2.837 * 0.04 * np.exp(1.68)
        assert float(xi[1]) == pytest.approx(lim, rel=1e-3)
        # and each matches the generic expression just off the point
        v_eps = jnp.asarray([-47.2, -77.1], jnp.float32)
        a_m_eps, _ = gate_rates(v_eps)["m"]
        assert float(a_m[0]) == pytest.approx(float(a_m_eps[0]), rel=2e-2)
        assert float(xi[1]) == pytest.approx(
            float(xi_factor(v_eps)[1]), rel=2e-2)

    def test_k1_rectification(self):
        """K1_inf is ~1 hyperpolarized and ~0 depolarized (the inward
        rectifier shuts during the plateau — the LR91 innovation over
        Beeler-Reuter's monotone iK1)."""
        assert float(k1_inf(jnp.float32(-90.0))) > 0.5
        assert float(k1_inf(jnp.float32(0.0))) < 0.01


class TestTissue:
    def test_2d_propagation(self):
        from fib_tf_tpu.engine import Simulation

        cfg = SimConfig(width=48, height=48, dt=0.02, duration=30)
        sim = Simulation(LuoRudy91(cfg)).define()
        res = sim.simulate()
        v = res.state["V"]
        assert np.isfinite(v).all()
        # the S1 stripe propagated across the midline within 30 ms
        assert (v[:, 24:] > -40.0).any()

    def test_gspmd_sharding_matches(self):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        from fib_tf_tpu.engine import Simulation

        devs = np.array(jax.devices()[:4]).reshape(4)
        mesh = Mesh(devs, ("x",))
        sharding = NamedSharding(mesh, PartitionSpec("x", None))
        cfg = SimConfig(width=48, height=48, dt=0.02, duration=5)
        res = Simulation(LuoRudy91(cfg), sharding=sharding) \
            .define().simulate()
        ref = Simulation(LuoRudy91(cfg)).define().simulate()
        np.testing.assert_allclose(
            res.state["V"], ref.state["V"], rtol=1e-5, atol=1e-5
        )


class TestMultiRateSkip:
    """cfg.skip applies the reference's Beeler-Reuter multi-rate
    technique (br.py:96-107) to lr1 (VERDICT r3 #2): slow x/d/f advance
    once per outer step at 10 dt = 0.2 ms, fast m/h/j every 0.02 ms
    substep.  Measured 0D: the full AP deviates < 0.01 mV from the
    uniform-rate trace."""

    @staticmethod
    def _ap_trace(skip, n_outer=2400):
        cfg = SimConfig(width=4, height=4, dt=0.02, duration=10,
                        skip=skip)
        m = LuoRudy91(cfg)
        st = {k: np.array(v) for k, v in m.initial_state(s1=False).items()}
        st["V"] = np.full_like(st["V"], -50.0)
        return _scan_trace(lambda s: m.step(s, GEOM), st, n_outer)[1]

    def test_0d_ap_matches_uniform_rate(self):
        a = self._ap_trace(False)
        b = self._ap_trace(True)
        # per-outer-step traces over the full 480 ms AP
        assert float(np.abs(a - b).max()) < 0.05

    def test_apd90_matches(self):
        rest = -84.5
        apds = []
        for skip in (False, True):
            tr = self._ap_trace(skip)
            peak = tr.max()
            thr = peak - 0.9 * (peak - rest)
            i_peak = int(tr.argmax())
            up = np.where(tr >= thr)[0][0]
            below = np.where(tr[i_peak:] < thr)[0]
            apds.append((i_peak + below[0] - up) * 0.2)
        assert apds[1] == pytest.approx(apds[0], abs=1.0)

    def test_tissue_state_matches(self):
        """2D propagation (S1 stripe) with skip stays within 0.2 mV of
        the uniform-rate state after 20 ms — the wavefront is where
        multi-rate error would show."""
        from fib_tf_tpu.models import grid_geometry

        geom = grid_geometry()
        states = []
        for skip in (False, True):
            cfg = SimConfig(width=48, height=48, dt=0.02, duration=10,
                            diff=0.809, skip=skip)
            m = LuoRudy91(cfg)
            st = {k: jnp.asarray(v) for k, v in m.initial_state().items()}
            step = jax.jit(lambda s, m=m: jax.lax.scan(
                lambda x, _: (m.step(x, geom), None), s, None, length=100
            )[0])
            states.append(jax.device_get(step(st)))
        np.testing.assert_allclose(
            states[1]["V"], states[0]["V"], atol=0.2, rtol=0
        )

    def test_skip_schedule_not_uniform(self):
        m = LuoRudy91(SimConfig(width=4, height=4, dt=0.02, skip=True))
        assert not m.has_uniform_substeps
        assert LuoRudy91(
            SimConfig(width=4, height=4, dt=0.02)
        ).has_uniform_substeps

    def _adaptive_trace(self, dv, n=500):
        cfg = SimConfig(width=4, height=4, dt=0.02, duration=10,
                        skip=True, adaptive_dv=dv, adaptive_depth=1)
        m = LuoRudy91(cfg)
        st = {k: np.array(v) for k, v in m.initial_state(s1=False).items()}
        st["V"] = np.full_like(st["V"], -50.0)
        return _scan_trace(lambda s: m.step(s, GEOM), st, n)[1]

    def test_adaptive_skip_untriggered_is_identical(self):
        """adaptive_dv + skip with a never-triggering threshold computes
        the exact skip schedule (the lax.cond fast path)."""
        tr = self._adaptive_trace(dv=1e3)
        ref = self._ap_trace(True, n_outer=500)
        assert float(np.abs(tr - ref).max()) < 1e-3

    def test_adaptive_skip_slow_gate_cadence(self):
        """Under adaptive_dv a refined skip group still advances the
        slow gates exactly 10 dt (two half-dt n=10 solves): the
        refinement may move the upstroke by a fraction of a substep
        (that's its job) but the plateau/repolarization — where a slow
        -gate cadence bug would accumulate — must track the fixed-dt
        skip trace."""
        tr = self._adaptive_trace(dv=4.0)
        ref = self._ap_trace(True, n_outer=500)
        # after the upstroke transient (first 10 ms = 50 outer steps)
        assert float(np.abs(tr[50:] - ref[50:]).max()) < 0.6
