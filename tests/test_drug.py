"""Channel-block (drug) interface — SimConfig.g_scale / IonicModel.set_scale.

The framework-level pharmacology layer (beyond reference parity: the
reference's only pharmacology was the hard-coded global chronic-AF flag,
court.py:193-194, 218).  Factors are trace-time constants folded into
the compiled step, so the contract under test is:

  * a factor of exactly 1.0 is BITWISE the unscaled model (the default
    path carries zero extra ops);
  * factors compose with the engine's scan, per-pixel heterogeneity
    planes, and chronic remodeling with no per-path plumbing;
  * the classic 0D pharmacology directions come out right: IKr block
    prolongs APD (hERG/dofetilide class), ICaL block shortens it
    (verapamil class), LR1's g_si tuning shortens it (the spiral-
    breakup literature's knob, Qu-Weiss-Garfinkel 1999).

0D dose-response tests are slow-tier; mechanics are smoke-tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import (
    MODEL_REGISTRY,
    BeelerReuter,
    Courtemanche,
    Fenton4v,
    TenTusscher06,
    cell_geometry,
    grid_geometry,
)

GEOM = grid_geometry()


def _step_once(model, state=None):
    st = state or {k: jnp.asarray(v) for k, v in model.initial_state().items()}
    return jax.device_get(jax.jit(lambda s: model.step(s, GEOM))(st))


def _scan_trace(model, state, n, geom=GEOM):
    state = {k: jnp.asarray(np.array(v)) for k, v in state.items()}

    def body(s, _):
        s = model.step(s, geom)
        return s, s[model.pot_key][0, 0]

    final, tr = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n)
    )(state)
    return jax.device_get(final), np.asarray(tr)


def _apd90(rest, tr, ms_per_sample):
    peak = tr.max()
    thr = peak - 0.9 * (peak - rest)
    i_peak = int(tr.argmax())
    up = np.where(tr >= thr)[0][0]
    below = np.where(tr[i_peak:] < thr)[0]
    assert len(below), "AP did not repolarize"
    return (i_peak + below[0] - up) * ms_per_sample


# -- mechanics (smoke tier) ----------------------------------------------------


class TestConfig:
    def test_dict_normalized_to_sorted_tuple(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1,
                        g_scale={"g_Kr": 0.5, "g_CaL": 0.8})
        assert cfg.g_scale == (("g_CaL", 0.8), ("g_Kr", 0.5))
        hash(cfg)  # stays usable as a jit static

    def test_tuple_form_accepted(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1,
                        g_scale=(("g_Kr", 0.5),))
        assert cfg.g_scale == (("g_Kr", 0.5),)

    @pytest.mark.parametrize("bad", [-0.1, float("nan"), float("inf")])
    def test_bad_factor_rejected(self, bad):
        with pytest.raises(ValueError, match="finite factor"):
            SimConfig(width=8, height=8, dt=0.02, duration=1,
                      g_scale={"g_Kr": bad})

    def test_replace_roundtrip(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1,
                        g_scale={"g_Kr": 0.5})
        assert cfg.replace(duration=2).g_scale == cfg.g_scale


class TestSetScale:
    def test_unknown_channel_raises(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1)
        with pytest.raises(ValueError, match="no scalable channel"):
            TenTusscher06(cfg).set_scale(g_nope=0.5)

    def test_config_routes_to_set_scale(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1,
                        g_scale={"g_Kr": 0.5})
        assert TenTusscher06(cfg).scales == {"g_Kr": 0.5}
        with pytest.raises(ValueError, match="no scalable channel"):
            Fenton4v(cfg.replace(dt=0.1))  # fenton has no g_Kr

    def test_none_removes(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1)
        m = TenTusscher06(cfg).set_scale(g_Kr=0.5).set_scale(g_Kr=None)
        assert m.scales == {}

    def test_every_model_declares_a_panel(self):
        for name, cls in MODEL_REGISTRY.items():
            assert cls.SCALE_PARAMS, name

    def test_adaptive_clones_carry_scales(self):
        """dt-refined substeps must not silently run drug-free."""
        cfg = SimConfig(width=8, height=8, dt=0.1, duration=1)
        m = Fenton4v(cfg).set_scale(g_fi=0.5)
        for clone in m.adaptive_clones()[1:]:
            assert clone.scales == {"g_fi": 0.5}


class TestTraceTimeFolding:
    def test_factor_one_is_bitwise_noop(self):
        cfg = SimConfig(width=12, height=12, dt=0.1, duration=1)
        base = _step_once(Fenton4v(cfg))
        ones = {n: 1.0 for n in Fenton4v.SCALE_PARAMS}
        scaled = _step_once(Fenton4v(cfg.replace(g_scale=ones)))
        for k in base:
            np.testing.assert_array_equal(base[k], scaled[k])

    def test_factor_changes_dynamics(self):
        cfg = SimConfig(width=12, height=12, dt=0.1, duration=1)
        base = _step_once(Fenton4v(cfg))
        blocked = _step_once(Fenton4v(cfg.replace(g_scale={"g_fi": 0.5})))
        assert np.abs(base["u"] - blocked["u"]).max() > 1e-6

    def test_engine_matches_step_under_block(self):
        """The factors fold into the engine's compiled scan exactly as
        into a bare jitted model step."""
        from fib_tf_tpu.engine import Simulation

        cfg = SimConfig(width=16, height=16, dt=0.1, duration=1,
                        dt_per_plot=5, cheby=True,
                        g_scale={"g_s": 0.6, "g_K1": 0.8})
        m = BeelerReuter(cfg)
        st = {k: jnp.asarray(v) for k, v in m.initial_state().items()}
        step = jax.jit(lambda s: m.step(s, GEOM))
        for _ in range(cfg.samples(m.dt_per_step)):
            st = step(st)
        got = Simulation(m).define().simulate().state
        for k in st:
            np.testing.assert_allclose(got[k], np.asarray(st[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)

    def test_composes_with_chronic_plane(self):
        """Dose x substrate: a CONSTANT chronic plane + g_Kr block equals
        the global chronic flag + the same block, bitwise."""
        cfg = SimConfig(width=12, height=12, dt=0.1, duration=1,
                        chronic=True, g_scale={"g_Kr": 0.5})
        flag = Courtemanche(cfg)
        plane = Courtemanche(cfg.replace(chronic=False)).set_het(
            chronic=np.ones((12, 12), np.float32))
        out_flag = _step_once(flag)
        st = {k: jnp.asarray(v) for k, v in plane.initial_state().items()}
        out_plane = _step_once(plane, st)
        for k in out_flag:
            np.testing.assert_array_equal(out_flag[k], out_plane[k])


class TestCliParse:
    def test_parse_gscale(self):
        from fib_tf_tpu.cli import _parse_gscale

        assert _parse_gscale(None) is None
        assert _parse_gscale("g_Kr=0.5,g_CaL=0.8") == {
            "g_Kr": 0.5, "g_CaL": 0.8}

    @pytest.mark.parametrize("bad", ["g_Kr", "g_Kr=x", "=0.5"])
    def test_parse_gscale_bad(self, bad):
        from fib_tf_tpu.cli import _parse_gscale

        with pytest.raises(SystemExit):
            _parse_gscale(bad)


# -- 0D pharmacology (slow tier) -----------------------------------------------


@pytest.mark.slow
class TestBeelerReuterPharm:
    """BR 0D: the slow-inward (Ca) current carries the plateau, the two
    K currents carry repolarization — block them and APD must move in
    opposite directions."""

    def _apd(self, g_scale=None):
        cfg = SimConfig(width=4, height=4, dt=0.1, duration=1,
                        g_scale=g_scale)
        m = BeelerReuter(cfg)
        st = m.initial_state(s1=False)
        st["V"] = np.full_like(st["V"], -30.0)  # suprathreshold jump
        _, tr = _scan_trace(m, st, 1200, geom=cell_geometry())
        return _apd90(-84.624, tr, m.dt_per_step * cfg.dt)

    def test_ca_block_shortens(self):
        assert self._apd({"g_s": 0.5}) < self._apd() - 20.0

    def test_k_block_prolongs(self):
        assert self._apd({"g_x1": 0.5}) > self._apd() + 20.0


@pytest.mark.slow
class TestTp06Pharm:
    """tp06 0D: the CiPA-class directions — IKr (hERG) block prolongs,
    ICaL block shortens, and the IKr dose-response is monotone."""

    def _apd(self, g_scale=None):
        cfg = SimConfig(width=4, height=4, dt=0.02, duration=1,
                        g_scale=g_scale)
        m = TenTusscher06(cfg)
        geom = cell_geometry()
        quiet, _ = _scan_trace(m, m.initial_state(s1=False), 1000, geom)
        rest = float(quiet["V"][0, 0])
        st = {k: np.array(v) for k, v in quiet.items()}
        st["V"] = np.full_like(st["V"], -60.0)
        _, tr = _scan_trace(m, st, 2500, geom)
        return rest, _apd90(rest, tr, m.dt_per_step * cfg.dt)

    @pytest.fixture(scope="class")
    def control(self):
        return self._apd()

    def test_ikr_block_prolongs(self, control):
        _, apd_ctrl = control
        _, apd_blk = self._apd({"g_Kr": 0.5})
        assert apd_blk > apd_ctrl + 10.0

    def test_ikr_dose_response_monotone(self, control):
        _, apd_ctrl = control
        apds = [self._apd({"g_Kr": f})[1] for f in (0.5, 0.25)]
        assert apd_ctrl < apds[0] < apds[1]

    def test_ical_block_shortens(self, control):
        _, apd_ctrl = control
        _, apd_blk = self._apd({"g_CaL": 0.5})
        assert apd_blk < apd_ctrl - 10.0

    def test_rest_potential_unmoved_by_kr_block(self, control):
        """IKr barely flows at rest — the block must not shift V_rest."""
        rest_ctrl, _ = control
        rest_blk, _ = self._apd({"g_Kr": 0.25})
        assert abs(rest_blk - rest_ctrl) < 1.0


class TestSpatialDose:
    """tp06's per-pixel IKr dose-factor plane (set_het(g_kr=...)): the
    spatially heterogeneous pharmacology instrument — border zones,
    washout gradients.  Unlike the absolute g_to/g_ks planes this one
    is a RELATIVE factor, so 1.0 is exactly baseline."""

    def _evolved(self, model, n=60):
        """Advance a uniform sheet into the AP plateau so IKr actually
        flows (xr gates ~0 at rest would make any dose invisible)."""
        st = model.initial_state(s1=False)
        st["V"] = np.full_like(st["V"], -30.0)
        final, _ = _scan_trace(model, st, n)
        return final

    def test_constant_plane_matches_global_dose(self):
        cfg = SimConfig(width=8, height=8, dt=0.02, duration=1)
        m_glob = TenTusscher06(cfg.replace(g_scale={"g_Kr": 0.5}))
        m_plane = TenTusscher06(cfg).set_het(
            g_kr=np.full((8, 8), 0.5, np.float32))
        out_g = self._evolved(m_glob)
        out_p = self._evolved(m_plane)
        for k in out_g:
            np.testing.assert_allclose(
                out_p[k], out_g[k], rtol=2e-6, atol=2e-6, err_msg=k)

    def test_half_plane_blocks_only_its_half(self):
        """One SUBSTEP (solve, not the 10-substep step — diffusion
        spreads the dose difference ~1 px per substep) from a uniform
        plateau state: the dose acts through the pointwise i_kr only,
        so the dosed half must equal the fully-dosed run and the
        undosed half the control, pixel for pixel."""
        cfg = SimConfig(width=16, height=8, dt=0.02, duration=1)
        ctrl = TenTusscher06(cfg)
        base = self._evolved(ctrl)

        plane = np.ones((8, 16), np.float32)
        plane[:, :8] = 0.25
        m_half = TenTusscher06(cfg).set_het(g_kr=plane)
        m_full = TenTusscher06(cfg).set_het(
            g_kr=np.full((8, 16), 0.25, np.float32))

        def one_step(m):
            st = {k: jnp.asarray(np.array(v)) for k, v in base.items()
                  if not k.startswith("_p_")}
            st.update({k: jnp.asarray(v) for k, v in
                       {m.HET_PREFIX + n: p for n, p in m.het.items()}.items()})
            return jax.device_get(jax.jit(lambda s: m.solve(s, GEOM))(st))

        out_ctrl = one_step(ctrl)
        out_half = one_step(m_half)
        out_full = one_step(m_full)
        # interior columns (1 px in from the dose border and edges)
        np.testing.assert_allclose(
            out_half["V"][:, 1:7], out_full["V"][:, 1:7], atol=1e-6)
        np.testing.assert_allclose(
            out_half["V"][:, 9:15], out_ctrl["V"][:, 9:15], atol=1e-6)
        # and the dosed half really did move
        assert np.abs(out_half["V"][:, 1:7]
                      - out_ctrl["V"][:, 1:7]).max() > 1e-4


@pytest.mark.slow
class TestShardedDrug:
    """The dose factors are model attributes closed over by every
    compiled path, so sharded == unsharded must hold with a block
    installed (wide-halo shard_map, the engine's default mesh path)."""

    def test_wide_halo_matches_unsharded(self):
        from fib_tf_tpu.parallel import make_mesh, shard_state
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        cfg = SimConfig(width=64, height=64, dt=0.1, duration=5,
                        cheby=True, g_scale={"g_s": 0.5, "g_x1": 0.7})
        m = BeelerReuter(cfg)
        st = {k: jnp.asarray(v) for k, v in m.initial_state().items()}

        def body(s, _):
            return m.step(s, GEOM), None

        want = jax.device_get(jax.jit(
            lambda s: jax.lax.scan(body, s, None, length=5)[0])(st))

        mesh = make_mesh()  # 8 virtual devices
        chunk = make_spmd_chunk(m, mesh, length=5, wide_halo=True)
        got, _ = chunk(shard_state(m.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6,
                err_msg=k)


@pytest.mark.slow
class TestBorderZoneDispersion:
    """A half-dosed strip under uniform pacing develops an APD step
    across the dose border — the substrate for unidirectional block."""

    def test_apd_step_across_border(self):
        cfg = SimConfig(width=64, height=4, dt=0.02, duration=1)
        plane = np.ones((4, 64), np.float32)
        plane[:, :32] = 0.25  # heavy IKr block on the left half
        m = TenTusscher06(cfg).set_het(g_kr=plane)
        geom = grid_geometry()

        quiet, _ = _scan_trace(m, m.initial_state(s1=False), 500, geom)
        rest = float(np.asarray(quiet["V"]).mean())
        st = {k: np.array(v) for k, v in quiet.items()}
        st["V"] = np.full_like(st["V"], -60.0)

        st = {k: jnp.asarray(v) for k, v in st.items()}

        def body(s, _):
            s = m.step(s, geom)
            return s, (s["V"][2, 5], s["V"][2, 58])

        _, (tr_l, tr_r) = jax.jit(
            lambda s: jax.lax.scan(body, s, None, length=2500)
        )(st)
        ms = m.dt_per_step * cfg.dt
        apd_l = _apd90(rest, np.asarray(tr_l), ms)
        apd_r = _apd90(rest, np.asarray(tr_r), ms)
        # blocked side longer, by a physiological margin despite the
        # electrotonic smoothing across the border
        assert apd_l > apd_r + 10.0


@pytest.mark.slow
class TestDrugInducedAlternans:
    """The proarrhythmic signature that links the drug interface to the
    alternans lab (r4): IKr block prolongs APD, which shortens the DI at
    a fixed pacing rate and pushes the cell up the steep restitution
    limb — measured on tp06 with dynamic_restitution_scan: at BCL 340 ms
    the 50% block roughly DOUBLES the beat-to-beat APD alternans
    (control 23.0 ms -> 49.4 ms) while 1:1 capture is maintained, and
    at the slow 450 ms rate it shows as plain APD prolongation
    (270.6 -> 287.6 ms) with no alternans."""

    BCLS = np.array([340.0, 450.0])

    def _scan(self, g_scale=None):
        from fib_tf_tpu.engine.restitution import dynamic_restitution_scan

        m = TenTusscher06(SimConfig(width=4, height=4, dt=0.02,
                                    duration=10, g_scale=g_scale))
        return dynamic_restitution_scan(m, self.BCLS, n_beats=6,
                                        tail_ms=450.0)

    @pytest.fixture(scope="class")
    def pair(self):
        return self._scan(), self._scan({"g_Kr": 0.5})

    def test_block_amplifies_alternans_at_fast_rate(self, pair):
        ctrl, blk = pair
        assert ctrl.captured.all() and blk.captured.all()
        assert ctrl.alternans_ms[0] == pytest.approx(23.0, abs=8.0)
        assert blk.alternans_ms[0] > ctrl.alternans_ms[0] + 15.0

    def test_block_prolongs_apd_at_slow_rate(self, pair):
        ctrl, blk = pair
        assert blk.apd_ms[1] > ctrl.apd_ms[1] + 10.0
        # no alternans at the slow rate in either arm
        assert ctrl.alternans_ms[1] < 3.0 and blk.alternans_ms[1] < 3.0


@pytest.mark.slow
class TestLuoRudyPharm:
    """LR1: scaling g_si down is the classic APD-shortening knob the
    spiral-breakup literature tunes (Qu, Weiss & Garfinkel 1999) —
    set_scale must reproduce the documented instance-attribute route."""

    def _apd(self, g_scale=None):
        from fib_tf_tpu.models import LuoRudy91

        cfg = SimConfig(width=4, height=4, dt=0.02, duration=1,
                        g_scale=g_scale)
        m = LuoRudy91(cfg)
        st = m.initial_state(s1=False)
        rest = float(st["V"][0, 0])
        st["V"] = np.full_like(st["V"], -30.0)
        _, tr = _scan_trace(m, st, 2500, geom=cell_geometry())
        return _apd90(rest, tr, m.dt_per_step * cfg.dt)

    def test_gsi_block_shortens(self):
        assert self._apd({"g_si": 0.5}) < self._apd() - 40.0
