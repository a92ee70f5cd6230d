"""ten Tusscher-Panfilov 2006 model (models/tp06.py — zoo extension, no
reference counterpart).

Published-physiology pins against ten Tusscher & Panfilov 2006 (Am J
Physiol 291:H1088): resting potential -86.2 mV, epicardial APD90
~302 ms, and the epi/endo/M transmural ordering (M cells repolarize
latest — reduced I_Ks); plus the machinery the model uniquely
exercises: the dt stability guard, the Ca-gated fCass gate, the ICaL
GHK singularity at V = 15 mV, and the multi-rate `skip` schedule on
the slow f/f2/s/xr1/xs gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import TenTusscher06, cell_geometry
from fib_tf_tpu.models.tp06 import (
    CELL_TYPES,
    SLOW_GATES,
    fcass_rates,
    gate_rates,
)


# long tail: excluded from the smoke tier (pytest -m 'not slow')
pytestmark = pytest.mark.slow

GEOM = cell_geometry()
CFG = SimConfig(width=4, height=4, dt=0.02, duration=10)


def _scan_trace(step_fn, state, n):
    state = {k: jnp.asarray(np.array(v)) for k, v in state.items()}

    def body(s, _):
        s = step_fn(s)
        return s, s["V"][0, 0]

    final, tr = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n)
    )(state)
    return jax.device_get(final), np.asarray(tr)


def _make(cell_type="epi", **kw):
    m = TenTusscher06(CFG.replace(**kw) if kw else CFG)
    m.cell_type = cell_type
    return m


def _ap(model, n_outer=2000, stim=-60.0):
    """Quiesce 200 ms from the paper's initial conditions, then a
    -60 mV suprathreshold jump (I_Na drives the upstroke), sampled per
    OUTER step (0.2 ms)."""
    quiet, _ = _scan_trace(
        lambda s: model.step(s, GEOM), model.initial_state(s1=False),
        1000)
    rest = float(quiet["V"][0, 0])
    stim_st = {k: np.array(v) for k, v in quiet.items()}
    stim_st["V"] = np.full_like(stim_st["V"], stim)
    _, tr = _scan_trace(lambda s: model.step(s, GEOM), stim_st, n_outer)
    return rest, tr


def _apd90(rest, tr, dt_sample=0.2):
    peak = tr.max()
    thr = peak - 0.9 * (peak - rest)
    i_peak = int(tr.argmax())
    up = np.where(tr >= thr)[0][0]
    below = np.where(tr[i_peak:] < thr)[0]
    assert len(below), "AP did not repolarize"
    return (i_peak + below[0] - up) * dt_sample


@pytest.fixture(scope="module")
def epi_ap():
    return _ap(_make())


class TestTP06Physiology:
    def test_resting_potential(self, epi_ap):
        rest, _ = epi_ap
        # paper: -86.2 mV initial condition; must hold it after 200 ms
        assert rest == pytest.approx(-86.2, abs=1.0)

    def test_ap_peak(self, epi_ap):
        _, tr = epi_ap
        # overshoot to ~+41 mV (paper Fig 1: ~+40)
        assert float(tr.max()) == pytest.approx(41.5, abs=3.0)

    def test_apd90_epi(self, epi_ap):
        rest, tr = epi_ap
        # paper Table 2: epi APD90 301.8 ms at 1 Hz
        assert _apd90(rest, tr) == pytest.approx(302.0, abs=8.0)

    def test_max_upstroke(self):
        """dV/dt max from the -60 mV jump, sampled per SUBSTEP.  The
        paper reports ~288 V/s from a threshold stimulus; the hard jump
        pre-loads more I_Na so the trace pins the measured 371."""
        m = _make()
        quiet, _ = _scan_trace(
            lambda s: m.step(s, GEOM), m.initial_state(s1=False), 1000)
        st = {k: np.array(v) for k, v in quiet.items()}
        st["V"] = np.full_like(st["V"], -60.0)
        _, tr = _scan_trace(lambda s: m.solve(s, GEOM), st, 2000)
        dvdt = np.diff(tr) / 0.02
        assert float(dvdt.max()) == pytest.approx(371.0, rel=0.10)

    def test_transmural_apd_ordering(self, epi_ap):
        """M cells (G_Ks 0.098 vs 0.392) repolarize far later than epi;
        endo sits within a few ms of epi (its smaller I_to barely moves
        APD90).  Measured: epi 302.6, endo 300.6, m 409.8 ms."""
        rest_e, tr_e = epi_ap
        apd_epi = _apd90(rest_e, tr_e)
        rest_m, tr_m = _ap(_make("m"), n_outer=3000)
        apd_m = _apd90(rest_m, tr_m)
        rest_n, tr_n = _ap(_make("endo"))
        apd_endo = _apd90(rest_n, tr_n)
        assert apd_m > apd_epi + 50.0
        assert apd_endo == pytest.approx(apd_epi, abs=10.0)

    def test_initial_gates_are_steady_states(self):
        st = _make().initial_state(s1=False)
        for g, (inf, _tau) in gate_rates(np.float64(-86.2), xp=np).items():
            np.testing.assert_allclose(st[g][0, 0], inf, rtol=1e-5)
        fc_inf, _ = fcass_rates(np.float64(7e-5), xp=np)
        np.testing.assert_allclose(st["fcass"][0, 0], fc_inf, rtol=1e-5)

    def test_calcium_transient(self):
        """First-beat Ca dynamics from the paper's initial conditions.
        The paper's Fig 1 systolic Cai (~1 uM) is a 1 Hz STEADY-STATE
        figure; from the initial CaSR = 1.3 mM the SR is unloaded, so
        beat 1 shows a small transient while SERCA net-loads the SR.
        Measured: diastolic 6.16e-5, peak 1.53e-4 (2.5x diastolic),
        CaSR 1.294 -> 1.438 mM over 400 ms, Cai recovering by the end
        (final/peak 0.64 and falling)."""
        m = _make()
        quiet, _ = _scan_trace(
            lambda s: m.step(s, GEOM), m.initial_state(s1=False), 1000)
        st = {k: np.array(v) for k, v in quiet.items()}
        diastolic = float(st["Cai"][0, 0])
        casr0 = float(st["CaSR"][0, 0])
        st["V"] = np.full_like(st["V"], -60.0)
        state = {k: jnp.asarray(v) for k, v in st.items()}

        def body(s, _):
            s = m.step(s, GEOM)
            return s, (s["Cai"][0, 0], s["CaSR"][0, 0])

        final, (ca, casr) = jax.jit(lambda s: jax.lax.scan(
            body, s, None, length=2000))(state)
        ca, casr = np.asarray(ca), np.asarray(casr)
        assert diastolic == pytest.approx(6.2e-5, rel=0.15)
        # a genuine transient: > 2x diastolic, in the measured window
        assert 1.0e-4 < float(ca.max()) < 2.5e-4
        assert float(ca.max()) > 2.0 * diastolic
        # SERCA net-loads the unloaded SR over the beat
        assert float(casr[-1]) > casr0 + 0.05
        # and Cai is relaxing back toward diastolic by 400 ms
        assert float(ca[-1]) < 0.75 * float(ca.max())
        assert ca[-1] < ca[-200]


class TestStiffnessMachinery:
    def test_dt_guard_rejects_reference_dt(self):
        with pytest.raises(ValueError, match="adaptive_dv"):
            TenTusscher06(SimConfig(width=4, height=4, dt=0.1))

    def test_adaptive_dv_rescues_dt_0p1(self):
        """At dt=0.1 (5x the paper's dt) step-doubling refines the
        upstroke substeps and produces a clean AP."""
        cfg = SimConfig(width=4, height=4, dt=0.1,
                        adaptive_dv=5.0, adaptive_depth=3)
        model = TenTusscher06(cfg)
        st = model.initial_state(s1=False)
        st["V"][:] = -60.0
        _, tr = _scan_trace(lambda s: model.step(s, GEOM), st, 450)
        assert np.isfinite(tr).all()
        assert float(tr.max()) == pytest.approx(41.5, abs=5.0)

    def test_ical_singularity_is_removable(self):
        """The GHK-like ICaL driving term at exactly V = 15 mV evaluates
        to its analytic limit, not NaN, and matches the generic
        expression just off the point."""
        m = _make()
        st = m.initial_state(s1=False)
        st = {k: jnp.asarray(np.array(v)) for k, v in st.items()}
        at = dict(st)
        at["V"] = jnp.full_like(st["V"], 15.0)
        cur_at = m.currents(at["V"], at)
        off = dict(st)
        off["V"] = jnp.full_like(st["V"], 15.01)
        cur_off = m.currents(off["V"], off)
        i_at = float(cur_at["i_cal"][0, 0])
        i_off = float(cur_off["i_cal"][0, 0])
        assert np.isfinite(i_at)
        assert i_at == pytest.approx(i_off, rel=2e-2)

    def test_positive_states_declared(self):
        assert set(TenTusscher06.positive_states) == {
            "Cai", "CaSR", "CaSS", "Nai", "Ki"}


class TestTissue:
    def test_2d_propagation(self):
        from fib_tf_tpu.engine import Simulation

        cfg = SimConfig(width=48, height=48, dt=0.02, duration=30)
        sim = Simulation(TenTusscher06(cfg)).define()
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
        res = Simulation(TenTusscher06(cfg), sharding=sharding) \
            .define().simulate()
        ref = Simulation(TenTusscher06(cfg)).define().simulate()
        np.testing.assert_allclose(
            res.state["V"], ref.state["V"], rtol=1e-5, atol=1e-5
        )


class TestMultiRateSkip:
    """cfg.skip applies the reference's Beeler-Reuter multi-rate
    technique (br.py:96-107) to tp06: slow f/f2/s/xr1/xs advance once
    per outer step at 10 dt = 0.2 ms, the sub-ms m/h/j (and the
    Ca-coupled fcass/Rq) every substep.  Measured 0D: the full AP
    deviates < 0.07 mV from the uniform-rate trace, APD90 identical to
    the 0.2 ms sample."""

    @staticmethod
    def _trace(skip, n_outer=2000):
        m = TenTusscher06(CFG.replace(skip=skip))
        quiet, _ = _scan_trace(
            lambda s: m.step(s, GEOM), m.initial_state(s1=False), 1000)
        st = {k: np.array(v) for k, v in quiet.items()}
        st["V"] = np.full_like(st["V"], -60.0)
        return _scan_trace(lambda s: m.step(s, GEOM), st, n_outer)[1]

    def test_0d_ap_matches_uniform_rate(self):
        a = self._trace(False)
        b = self._trace(True)
        assert float(np.abs(a - b).max()) < 0.2

    def test_apd90_matches(self):
        apds = []
        for skip in (False, True):
            tr = self._trace(skip)
            apds.append(_apd90(-86.1, tr))
        assert apds[1] == pytest.approx(apds[0], abs=1.0)

    def test_skip_schedule_not_uniform(self):
        assert not TenTusscher06(CFG.replace(skip=True)) \
            .has_uniform_substeps
        assert TenTusscher06(CFG).has_uniform_substeps

    def test_slow_gates_frozen_on_skip_substeps(self):
        """solve(n=0) must not move the slow gates."""
        m = TenTusscher06(CFG.replace(skip=True))
        st = {k: jnp.asarray(np.array(v))
              for k, v in m.initial_state(s1=False).items()}
        st["V"] = jnp.full_like(st["V"], 0.0)  # rates far from steady
        out = m.solve(st, GEOM, n=0)
        for g in SLOW_GATES:
            np.testing.assert_array_equal(np.array(out[g]),
                                          np.array(st[g]))


class TestCellTypes:
    def test_registry_and_conductances(self):
        assert set(CELL_TYPES) == {"epi", "endo", "m"}
        g_to_epi, g_ks_epi = CELL_TYPES["epi"]
        g_to_endo, _ = CELL_TYPES["endo"]
        _, g_ks_m = CELL_TYPES["m"]
        assert g_to_endo < g_to_epi      # smaller notch current
        assert g_ks_m < g_ks_epi         # reduced IKs -> long APD

    def test_endo_s_gate_shape_differs(self):
        v = np.float64(-30.0)
        (inf_e, tau_e) = gate_rates(v, xp=np, which=("s",))["s"]
        (inf_n, tau_n) = gate_rates(v, xp=np, which=("s",),
                                    cell_type="endo")["s"]
        assert inf_e != pytest.approx(inf_n, rel=1e-3)
        assert tau_e != pytest.approx(tau_n, rel=1e-3)


class TestRestitution:
    """S1-S2 APD restitution (engine/restitution.py) for tp06.  The
    paper's central theme is restitution-slope-controlled breakup; the
    default parameter set is its steep variant, and this protocol
    measures a steep short-DI limb here too.  Measured (BCL 700, 2 S1,
    uniform 4x4 stimulation, 0.2 ms sampling): last-S1 APD90 296.4 ms,
    refractory at S2 = 280 ms, capture from 320 ms, APD(DI) monotone
    23.6->303.6 ms, max finite-difference slope 1.62."""

    @pytest.fixture(scope="class")
    def result(self):
        from fib_tf_tpu.engine.restitution import restitution_scan

        m = TenTusscher06(SimConfig(width=4, height=4, dt=0.02,
                                    duration=10))
        return restitution_scan(
            m, coupling_ms=np.array([280.0, 320.0, 340.0, 400.0, 600.0]),
            bcl_ms=700.0, n_s1=2, tail_ms=450.0)

    def test_s1_apd(self, result):
        assert result.apd_s1_ms == pytest.approx(296.4, abs=8.0)

    def test_refractory_edge(self, result):
        assert not result.captured[0]          # S2 280 ms: no capture
        assert result.captured[1:].all()       # 320 ms onward captures

    def test_apd_monotone_in_di(self, result):
        di, apd = result.di_ms[1:], result.apd_ms[1:]
        assert (np.diff(di) > 0).all()
        assert (np.diff(apd) > 0).all()
        assert apd[-1] <= result.apd_s1_ms + 5.0

    def test_steep_short_di_slope(self, result):
        # default-parameter tp06 is the steep-restitution regime the
        # paper's breakup analysis builds on: slope well above 1 at
        # short DI (measured 1.62 between DI 23.6 and 43.6 ms)
        s = result.slope()
        assert s is not None
        assert s == pytest.approx(1.62, rel=0.2)
        assert s > 1.0


class TestAlternans:
    """Dynamic-restitution alternans — the phenomenon the tp06 paper is
    built around.  Default (steep) parameters, measured with
    dynamic_restitution_scan (6 beats, uniform 4x4 stimulation):
    clear APD alternans at BCL 320 ms (253.2 / 207.2 ms, Δ = 46 ms),
    vanishing by BCL 400 (Δ 2.2 ms) and 600 (Δ 0.4 ms); at BCL <= 280 ms
    1:1 capture is lost (2:1 block — every other beat drops)."""

    @pytest.fixture(scope="class")
    def result(self):
        from fib_tf_tpu.engine.restitution import dynamic_restitution_scan

        m = TenTusscher06(SimConfig(width=4, height=4, dt=0.02,
                                    duration=10))
        return dynamic_restitution_scan(
            m, np.array([280.0, 320.0, 400.0, 600.0]),
            n_beats=6, tail_ms=450.0)

    def test_two_to_one_block_at_280(self, result):
        assert not result.captured[0]
        # the penultimate beat DID fire (it's 2:1 block, not quiescence)
        assert np.isfinite(result.apd_prev_ms[0])

    def test_alternans_at_320(self, result):
        assert result.captured[1]
        assert result.alternans_ms[1] == pytest.approx(46.0, abs=12.0)
        assert result.apd_ms[1] == pytest.approx(207.2, abs=10.0)
        assert result.apd_prev_ms[1] == pytest.approx(253.2, abs=10.0)

    def test_alternans_vanishes_at_long_bcl(self, result):
        assert result.captured[2:].all()
        assert result.alternans_ms[2] < 6.0
        assert result.alternans_ms[3] < 2.0
        # steady-state APD at 1 Hz-ish pacing near the paper's 302 ms
        assert result.apd_ms[3] == pytest.approx(293.8, abs=8.0)


class TestConduction:
    def test_plane_wave_cv(self):
        """Plane-wave conduction velocity at diff=0.809: measured 2.22
        cells/ms (-40 mV upstroke crossings at x=60/200 on a 256-wide
        strip).  The example's cut-the-wave timing derives from this
        number (examples/tp06_spiral.py)."""
        from fib_tf_tpu.models import grid_geometry

        cfg = SimConfig(width=256, height=16, dt=0.02, diff=0.809,
                        duration=1)
        m = TenTusscher06(cfg)
        st = m.initial_state(s1=True)
        geom = grid_geometry()
        s = {k: jnp.asarray(np.array(v)) for k, v in st.items()}

        def body(c, _):
            c = m.step(c, geom)
            return c, c["V"][8, :]

        _, tr = jax.jit(
            lambda c: jax.lax.scan(body, c, None, length=600))(s)
        tr = np.asarray(tr)   # 0.2 ms per outer step

        def tcross(x):
            idx = np.where(tr[:, x] > -40.0)[0]
            assert len(idx), f"wave never reached x={x}"
            return idx[0] * 0.2

        cv = (200 - 60) / (tcross(200) - tcross(60))
        assert cv == pytest.approx(2.22, rel=0.10)
