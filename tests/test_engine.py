"""Tissue-level integration tests through the Simulation engine:
planar-wave propagation, S1-S2 protocol, events, probes, checkpoint/resume
(SURVEY.md §4b-c)."""

import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.engine.observers import (
    CycleLengthDetector,
    fibrillation_density,
    phase_weighted_mean,
)
from fib_tf_tpu.models import Fenton4v


def small_cfg(**kw):
    base = dict(width=48, height=48, dt=0.1, dt_per_plot=10,
                diff=1.5, duration=20)
    base.update(kw)
    return SimConfig(**base)


class TestPlanarWave:
    def test_fenton_wave_crosses_grid(self):
        cfg = small_cfg(duration=30)
        sim = Simulation(Fenton4v(cfg)).define()
        res = sim.simulate()
        # S1 stripe at the left edge launches a wave that should have
        # reached the right edge well within 30 ms at diff=1.5
        u_final = res.state["u"]
        assert u_final[24, -2] > 0.5
        assert np.isfinite(u_final).all()

    def test_no_s1_no_wave(self):
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg))
        sim.define(s1=False)
        res = sim.simulate()
        assert res.state["u"].max() < 0.1


class TestEvents:
    def test_s2_fires(self):
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg)).define()
        sim.add_pace_op("s2", "luq", 1.0)
        res = sim.simulate(schedule=[(5, "s2")])
        # after the S2 quadrant fire, the LUQ should have been depolarized;
        # final state is 5 ms later so just assert the run completed and
        # probes show elevated activity
        assert res.steps == 10
        assert np.isfinite(res.state["u"]).all()

    def test_events_at_boundaries(self):
        """Events at t=0 and t=duration must not break segmentation."""
        cfg = small_cfg(duration=6)
        sim = Simulation(Fenton4v(cfg)).define()
        sim.add_pace_op("a", "top", 1.0)
        sim.add_pace_op("b", "bottom", 1.0)
        res = sim.simulate(schedule=[(0, "a"), (6, "b"), (3, "a")])
        assert res.steps == 6

    def test_court_trend_probe_stream(self):
        """Courtemanche emits the trend probe (V, Na_i at the reference
        pixel) once per outer step = once per 10 dt, court.py:107-112."""
        from fib_tf_tpu.models import Courtemanche

        cfg = small_cfg(duration=5, diff=0.809)
        sim = Simulation(Courtemanche(cfg)).define()
        res = sim.simulate()
        assert res.probes["trend"].shape == (5, 2)
        # Na_i stays near its initial 11.17 mM over 5 ms
        assert abs(res.probes["trend"][-1, 1] - 11.17) < 0.5

    def test_pace_before_define_raises(self):
        sim = Simulation(Fenton4v(small_cfg()))
        with pytest.raises(AssertionError):
            sim.add_pace_op("s2", "luq", 1.0)

    def test_hole_after_define_raises(self):
        sim = Simulation(Fenton4v(small_cfg())).define()
        with pytest.raises(AssertionError):
            sim.add_hole_to_phase_field(10, 10, 5)


class TestProbes:
    def test_probe_stream_length(self):
        cfg = small_cfg(duration=20)
        sim = Simulation(Fenton4v(cfg)).define()
        res = sim.simulate()
        assert res.probes["v"].shape == (20,)

    def test_electrode_probe(self):
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg))
        sim.add_electrode(30, 24, radius=3)
        sim.add_electrode(20, 24, radius=3)
        sim.define()
        res = sim.simulate()
        assert res.probes["egm"].shape == (10, 2)
        assert np.isfinite(res.probes["egm"]).all()

    def test_ecg_electrode_matches_manual_integral(self):
        """Far-field pseudo-ECG (add_ecg_electrode): the stream equals
        the hand-computed lead-field integral of the model's own
        discrete diffusion source term."""
        import jax.numpy as jnp

        from fib_tf_tpu.models.base import grid_geometry
        from fib_tf_tpu.ops import stencil

        cfg = small_cfg(duration=8)
        sim = Simulation(Fenton4v(cfg))
        sim.add_ecg_electrode(24, 24, z=4.0)
        sim.add_ecg_electrode(5, 40, z=0.0)  # in-plane: r_min floor
        sim.define()
        res = sim.simulate()
        e = res.probes["ecg"]
        assert e.shape == (8, 2)

        m = Fenton4v(cfg)
        geom = grid_geometry()
        s = {k: jnp.asarray(v) for k, v in m.initial_state().items()}
        w = np.stack([
            stencil.ecg_weights(48, 48, 24, 24, 4.0),
            stencil.ecg_weights(48, 48, 5, 40, 0.0),
        ])
        for i in range(8):
            s = m.step(s, geom)
            lap = np.asarray(geom.laplace(geom.enforce_boundary(s["u"])))
            expect = np.einsum("hw,ehw->e", lap, w)
            np.testing.assert_allclose(e[i], expect, rtol=1e-4,
                                       atol=1e-5)

    def test_ecg_accepted_on_shard_map_mesh(self):
        """ECG rides the shard_map mesh — including fiber runs (r4
        closed the last mesh observable gap; parity is asserted in
        test_sharding.TestShardedAnisotropy::test_fiber_ecg_matches)."""
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs >= 2 devices")
        mesh = Mesh(np.array(devs[:2]), ("rows",))
        for kw in ({}, dict(fiber_angle=0.5, fiber_ratio=0.5)):
            sim = Simulation(Fenton4v(small_cfg(**kw)), mesh=mesh,
                             wide_halo=True)
            sim.add_ecg_electrode(24, 24)  # must not raise

    def test_frames_recorded(self):
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg)).define()
        res = sim.simulate(record_frames_every_ms=2)
        assert res.frames is not None
        assert res.frames.shape == (5, 48, 48)

    def test_frames_survive_odd_event(self):
        """An event landing between frame strides must not desync frame
        recording (chunks realign to the stride; ADVICE r1 #2)."""
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg)).define()
        sim.add_pace_op("s2", "luq", 1.0)
        res = sim.simulate(schedule=[(2.5, "s2")],
                           record_frames_every_ms=2)
        assert res.frames is not None
        assert res.frames.shape == (5, 48, 48)

    def test_ultra_probe_stream_is_live(self):
        """court_ultra's phase-weighted means ride the probe stream; the
        final streamed row must match a host recompute on the final state
        and the stream must actually evolve (VERDICT r1 weak #4)."""
        from fib_tf_tpu.models import CourtemancheUltra
        from fib_tf_tpu.models.courtemanche import us_rates

        cfg = small_cfg(duration=5, diff=0.809, ultra_slow=True)
        sim = Simulation(CourtemancheUltra(cfg))
        sim.add_hole_to_phase_field(24, 24, 6)
        sim.define()
        res = sim.simulate()
        assert res.probes["ultra"].shape == (5, 5)
        # stream evolves mid-run (the S1 stripe depolarizes tissue)
        assert not np.allclose(res.probes["ultra"][0],
                               res.probes["ultra"][-1])
        # final row == host recompute on the final state
        last = res.probes["ultra"][-1]
        us_inf, tau_us = us_rates(res.state["V"], np)
        expect = [
            phase_weighted_mean(res.state["Na_i"], sim.phase),
            phase_weighted_mean(res.state["f_Ca"], sim.phase),
            phase_weighted_mean(res.state["us"], sim.phase),
            phase_weighted_mean(us_inf, sim.phase),
            phase_weighted_mean(tau_us, sim.phase),
        ]
        np.testing.assert_allclose(last, expect, rtol=2e-3)


class TestAPIEquivalence:
    def test_simulate_matches_run_generator(self):
        """simulate(schedule=[(t, op)]) and the run()/fire_op generator
        must produce bit-identical states for the same S2 time — the
        reference has one protocol, not two (ADVICE r1 #3)."""
        cfg = small_cfg(duration=5)

        sim_a = Simulation(Fenton4v(cfg)).define()
        sim_a.add_pace_op("s2", "luq", 1.0)
        res = sim_a.simulate(schedule=[(2, "s2")])

        sim_b = Simulation(Fenton4v(cfg)).define()
        sim_b.add_pace_op("s2", "luq", 1.0)
        s2 = sim_b.millisecond_to_step(2)
        for i in sim_b.run(im=None, keep_state=True):
            if i == s2:
                sim_b.fire_op("s2")

        np.testing.assert_array_equal(res.state["u"], sim_b.state["u"])


class TestTickDispatch:
    def test_fast_slow_ratio_dispatch(self):
        """ode_op(tick) analog (reference ionic.py:277-286): a model with
        fast_slow_ratio gets slow_step on every ratio-th outer tick of
        run() and fast_step otherwise."""
        import jax.numpy as jnp

        from fib_tf_tpu.models import Fenton4v, grid_geometry

        class TickModel(Fenton4v):
            fast_slow_ratio = 3

            def fast_step(self, state, geom):
                # marker: bump s by 1 (s is otherwise in [0, 1])
                return {**state, "s": state["s"] + 1.0}

            def slow_step(self, state, geom):
                return {**state, "s": state["s"] + 100.0}

        cfg = small_cfg(duration=6)
        sim = Simulation(TickModel(cfg)).define()
        for _ in sim.run(im=None, keep_state=True):
            pass
        # ticks 0..5 -> slow at 0 and 3 (2x +100), fast at the rest (4x +1)
        assert float(sim.state["s"][0, 0]) == pytest.approx(204.0)

    def test_simulate_matches_run_generator(self):
        """simulate() scans whole ratio-groups per iteration (VERDICT r2
        #6) and must land on the same final state and per-outer-step
        dispatch sequence as the run() generator."""
        from fib_tf_tpu.models import Fenton4v

        class TickModel(Fenton4v):
            fast_slow_ratio = 3

            def fast_step(self, state, geom):
                return {**state, "s": state["s"] + 1.0}

            def slow_step(self, state, geom):
                return {**state, "s": state["s"] + 100.0}

        # duration=7 outer steps: 2 full groups + 1-step tail
        cfg = small_cfg(duration=7)
        sim1 = Simulation(TickModel(cfg)).define()
        for _ in sim1.run(im=None, keep_state=True):
            pass
        sim2 = Simulation(TickModel(cfg)).define()
        res = sim2.simulate()
        assert res.steps == 7
        assert res.probes["v"].shape[0] == 7
        # ticks 0..6: slow at 0, 3, 6 (3x +100), fast at the rest (4x +1)
        assert float(res.state["s"][0, 0]) == pytest.approx(304.0)
        np.testing.assert_array_equal(sim1.state["s"], res.state["s"])

    def test_simulate_ratio_snaps_events_to_groups(self):
        """Pacing events snap to ratio-group boundaries so every chunk
        starts at a tick ≡ 0 (mod ratio)."""
        from fib_tf_tpu.models import Fenton4v

        class TickModel(Fenton4v):
            fast_slow_ratio = 3

            def fast_step(self, state, geom):
                return {**state, "s": state["s"] + 1.0}

            def slow_step(self, state, geom):
                return {**state, "s": state["s"] + 100.0}

        cfg = small_cfg(duration=9)
        sim = Simulation(TickModel(cfg)).define()
        sim.add_pace_op("s2", "luq", 1.0)
        # 4 ms -> step 4+1=5, snaps to 6 (group boundary)
        res = sim.simulate(schedule=[(4.0, "s2")])
        assert res.steps == 9
        # dispatch unaffected: slow at 0,3,6 (+300), fast 6x (+6)
        assert float(res.state["s"][0, 0]) == pytest.approx(306.0)

    def test_default_models_unchanged(self):
        """Without fast_slow_ratio, step_for_tick is the fused step."""
        from fib_tf_tpu.models import Fenton4v, grid_geometry
        import jax.numpy as jnp

        model = Fenton4v(small_cfg())
        geom = grid_geometry()
        s = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        a = model.step_for_tick(s, geom, tick=0)
        b = model.step(s, geom)
        np.testing.assert_array_equal(np.asarray(a["u"]), np.asarray(b["u"]))


class TestCheckpointResume:
    def test_state_handoff(self):
        """Two-model chained run passing state (reference court.py:615-636
        pattern, tested here on the cheaper Fenton model)."""
        cfg = small_cfg(duration=10)
        sim1 = Simulation(Fenton4v(cfg)).define()
        res1 = sim1.simulate()

        sim2 = Simulation(Fenton4v(cfg))
        sim2.define(state=res1.state)
        res2 = sim2.simulate()

        # continuing 10+10 ms must equal a single 20 ms run
        sim3 = Simulation(Fenton4v(small_cfg(duration=20))).define()
        res3 = sim3.simulate()
        np.testing.assert_allclose(
            res2.state["u"], res3.state["u"], rtol=1e-5, atol=1e-5
        )


class TestPhaseFieldRun:
    def test_hole_blocks_tissue(self):
        cfg = small_cfg(duration=30)
        sim = Simulation(Fenton4v(cfg))
        sim.add_hole_to_phase_field(24, 24, 8)
        sim.define()
        res = sim.simulate()
        assert np.isfinite(res.state["u"]).all()
        # the wave still crosses around the obstacle
        assert res.state["u"][24, -2] > 0.5 or res.probes["v"].max() > 0.5


class TestGeneratorAPI:
    def test_run_with_headless_screen(self):
        """run(im=Screen) paints phase-masked frames every plot interval
        (reference ionic.py:206-215)."""
        from fib_tf_tpu.utils.viz import Screen

        cfg = small_cfg(duration=4)
        sim = Simulation(Fenton4v(cfg))
        sim.add_hole_to_phase_field(24, 24, 6)
        sim.define()
        im = Screen(48, 48, backend="headless", keep_all_frames=True)
        for _ in sim.run(im=im):
            pass
        assert len(im._backend.frames) == 4

    def test_run_generator_with_fire_op(self):
        cfg = small_cfg(duration=5)
        sim = Simulation(Fenton4v(cfg)).define()
        sim.add_pace_op("s2", "luq", 1.0)
        seen = []
        for i in sim.run(im=None, keep_state=True):
            seen.append(i)
            if i == 2:
                sim.fire_op("s2")
        assert seen == list(range(5))
        assert sim.state is not None
        assert np.isfinite(sim.state["u"]).all()


class TestReferenceStyleWorkflow:
    def test_reference_script_shape(self):
        """The full reference scripting pattern (fenton.py:155-187):
        dict config -> model -> hole -> define -> pace op -> run generator
        with fire_op + frame harvesting into a cube."""
        config = {
            "width": 48, "height": 48, "dt": 0.1, "dt_per_plot": 10,
            "diff": 1.5, "duration": 6, "timeline": False,
            "save_graph": False,
        }
        cfg = SimConfig.from_dict(config)
        sim = Simulation(Fenton4v(cfg))
        sim.add_hole_to_phase_field(24, 24, 6)
        sim.define()
        sim.add_pace_op("s2", "luq", 1.0)

        s2 = sim.millisecond_to_step(3)
        frames = []
        for i in sim.run(im=None, keep_state=True):
            if i == s2:
                sim.fire_op("s2")
            frames.append(i)
        assert frames == list(range(6))
        assert sim.state is not None


class TestObserverHelpers:
    def test_cycle_length_detector(self):
        det = CycleLengthDetector(dt=0.1, dt_per_step=10, plot_interval=1)
        clock = []
        det.observer = lambda i, cl: clock.append((i, cl))
        # two upward crossings 50 steps apart
        series = np.zeros(100, dtype=np.float32)
        series[10:20] = 1.0
        series[60:70] = 1.0
        det.feed(0, series)
        assert len(clock) == 2
        assert clock[1][1] == pytest.approx((60 - 10) * 10 * 0.1)

    def test_fibrillation_density(self):
        img = np.zeros((10, 10), dtype=np.float32)
        img[:5] = 1.0
        assert fibrillation_density(img, None) == pytest.approx(0.5)

    def test_phase_weighted_mean(self):
        field = np.asarray([[1.0, 3.0]])
        phase = np.asarray([[1.0, 3.0]])
        assert phase_weighted_mean(field, phase) == pytest.approx(2.5)


class TestObservability:
    def test_timeline_trace_written(self, tmp_path, monkeypatch):
        """cfg.timeline -> a jax.profiler trace directory (the Chrome-trace
        timeline analog, reference ionic.py:231-241)."""
        monkeypatch.chdir(tmp_path)
        cfg = small_cfg(duration=3, timeline=True,
                        timeline_name="tl.json")
        sim = Simulation(Fenton4v(cfg)).define()
        sim.simulate()
        import os

        assert os.path.isdir("tl_trace")

    def test_save_graph_hlo_dump(self, tmp_path, monkeypatch):
        """cfg.save_graph -> HLO text dump (the TF graph-dump analog,
        reference ionic.py:190-191)."""
        monkeypatch.chdir(tmp_path)
        cfg = small_cfg(duration=3, save_graph=True)
        sim = Simulation(Fenton4v(cfg)).define()
        sim.simulate()
        import os

        assert os.path.getsize("logs/fenton_step_hlo.txt") > 0


class TestEnsemble:
    def test_vmapped_members_independent(self):
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        s_wave = model.initial_state(s1=True)
        s_rest = model.initial_state(s1=False)
        stacked = stack_states([s_wave, s_rest])
        final, probes = run_ensemble(model, stacked, n_outer=5)
        assert probes.shape == (2, 5)
        # member 0 has a propagating wave; member 1 stays quiescent
        assert final["u"][0].max() > 0.5
        assert final["u"][1].max() < 0.1

    def test_adaptive_members_run_on_xla_path(self):
        """adaptive_dv ensembles run the vmapped step: under vmap the
        cond lowers to select (both branches execute), value-identical
        to the per-member cond."""
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states

        cfg = small_cfg(duration=5).replace(adaptive_dv=1e9,
                                            adaptive_depth=1)
        model = Fenton4v(cfg)
        plain = Fenton4v(small_cfg(duration=5))
        stacked = stack_states([model.initial_state(s1=True)] * 2)
        final, probes = run_ensemble(model, stacked, n_outer=2)
        want, _ = run_ensemble(plain, stacked, n_outer=2)
        for k in want:
            np.testing.assert_allclose(final[k], want[k],
                                       rtol=1e-6, atol=1e-8)

    def test_sharded_over_mesh(self):
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states
        from fib_tf_tpu.parallel import make_mesh

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        members = [model.initial_state(s1=True) for _ in range(8)]
        stacked = stack_states(members)
        mesh = make_mesh()
        final, probes = run_ensemble(model, stacked, n_outer=3, mesh=mesh)
        # all members identical -> identical results
        for i in range(1, 8):
            np.testing.assert_array_equal(final["u"][0], final["u"][i])

    def test_sharded_matches_unmeshed(self):
        """The member axis sharded over the mesh, with per-member
        events: results match the unmeshed run."""
        from fib_tf_tpu.engine.ensemble import (
            EnsembleEvent, run_ensemble, stack_states,
        )
        from fib_tf_tpu.parallel import make_mesh

        cfg = small_cfg(width=128, height=16, duration=5)
        model = Fenton4v(cfg)
        stacked = stack_states([model.initial_state(s1=True)] * 8)
        ev = EnsembleEvent(
            step=np.array([1, 2, 3, 4, 5, 99, 99, 99]), loc="luq", v=1.0
        )
        f_ref, p_ref = run_ensemble(model, stacked, 6, events=[ev])
        f_mesh, p_mesh = run_ensemble(
            model, stacked, 6, events=[ev], mesh=make_mesh(),
        )
        for k in f_ref:
            np.testing.assert_allclose(
                f_mesh[k], f_ref[k], rtol=1e-5, atol=1e-6, err_msg=k
            )
        np.testing.assert_allclose(p_mesh, p_ref, rtol=1e-5, atol=1e-6)

    def test_mesh_pads_uneven_batch(self):
        """n=5 members on an 8-device mesh: the batch is padded to the
        shard multiple with dummy members and every output is cropped
        back."""
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states
        from fib_tf_tpu.parallel import make_mesh

        cfg = small_cfg(width=128, height=16, duration=5)
        model = Fenton4v(cfg)
        stacked = stack_states(
            [model.initial_state(s1=(i % 2 == 0)) for i in range(5)]
        )
        f_ref, p_ref = run_ensemble(model, stacked, 4)
        f, p = run_ensemble(model, stacked, 4, mesh=make_mesh())
        assert f["u"].shape == (5, cfg.height, cfg.width)
        assert p.shape == (5, 4)
        np.testing.assert_allclose(f["u"], f_ref["u"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p, p_ref, rtol=1e-5, atol=1e-6)

    def test_event_fires_at_per_member_step(self):
        from fib_tf_tpu.engine.ensemble import (
            EnsembleEvent, run_ensemble, stack_states,
        )

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        stacked = stack_states([model.initial_state(s1=False)] * 3)
        ev = EnsembleEvent(step=np.array([1, 4, 99]), loc="luq", v=1.0)
        final, probes = run_ensemble(
            model, stacked, n_outer=8, events=[ev],
            probe=lambda s: s["u"].max(),
        )
        # member 0 stimulated at step 1, member 1 at step 4, member 2 never
        assert probes[0, 0] < 0.1 and probes[0, 1] >= 0.99
        assert probes[1, 3] < 0.1 and probes[1, 4] >= 0.99
        assert (probes[2] < 0.1).all()

    def test_per_member_phase(self):
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        h, w = cfg.height, cfg.width
        from fib_tf_tpu.ops.stencil import add_hole_to_phase_field

        ones = np.ones((h, w), np.float32)
        hole = add_hole_to_phase_field(None, h, w, w // 2, h // 2, 8)
        stacked = stack_states([model.initial_state(s1=True)] * 2)

        # per-member [2,H,W]: member 0 plain, member 1 with the obstacle
        per_member = np.stack([ones, hole])
        final, _ = run_ensemble(model, stacked, 10, phase=per_member)
        assert not np.allclose(final["u"][0], final["u"][1])

        # the shared-[H,W] path and the per-member path agree member-wise
        final_shared, _ = run_ensemble(
            model, stack_states([model.initial_state(s1=True)]), 10,
            phase=hole,
        )
        np.testing.assert_allclose(
            final["u"][1], final_shared["u"][0], atol=1e-5
        )

    def test_probe_dict_streams(self):
        from fib_tf_tpu.engine.ensemble import run_ensemble, stack_states

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        stacked = stack_states([model.initial_state(s1=True)] * 2)
        final, probes = run_ensemble(
            model, stacked, 4,
            probe=lambda s: {"front": model.probe(s),
                             "mean_u": s["u"].mean()},
        )
        assert set(probes) == {"front", "mean_u"}
        assert probes["front"].shape == (2, 4)
        assert probes["mean_u"].shape == (2, 4)
        assert np.isfinite(probes["mean_u"]).all()

    def test_s2_scan_classifies(self):
        from fib_tf_tpu.engine.ensemble import s2_scan

        cfg = small_cfg(duration=5)
        model = Fenton4v(cfg)
        # member 1's S2 never fires: its S1 wave exits the tiny sheet and
        # repolarizes (APD ~200 ms) -> died out.  member 0 is re-stimulated
        # near the end, so tissue is still active at the horizon.
        steps, sustained, probes = s2_scan(
            model, n_outer=320, s2_steps=np.array([300, 10_000])
        )
        assert probes.shape == (2, 320)
        assert sustained.dtype == bool
        assert sustained[0] and not sustained[1]


class TestFailureDetection:
    def test_nan_raises(self):
        cfg = small_cfg(duration=10)
        sim = Simulation(Fenton4v(cfg)).define()
        bad = sim.model.initial_state()
        bad["u"][0, 0] = np.nan
        with pytest.raises(FloatingPointError):
            sim.simulate(state=bad)
