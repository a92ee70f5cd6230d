"""Adaptive-dt step-doubling (SimConfig.adaptive_dv, ops/adaptive.py).

Beyond reference parity: the reference integrated fixed-dt explicit Euler
and rode through blowups (its NaN check was commented out, reference
ionic.py:208-212).  These tests pin the three properties that make the
adaptive integrator trustworthy:

  * untriggered == plain (same substeps, ulp-level identical);
  * always-triggered == the half-dt trajectory (the refinement is a real
    half-dt integration, not a clip);
  * a configuration where plain Euler provably blows up (Courtemanche 2D
    at dt=0.3, past the explicit diffusion stability limit AND past the
    Ca-release subsystem's slow-plane limit) runs stably.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models.base import cell_geometry, grid_geometry
from fib_tf_tpu.models.beeler_reuter import BeelerReuter
from fib_tf_tpu.models.courtemanche import Courtemanche, CourtemancheUltra
from fib_tf_tpu.models.fenton import Fenton4v



# long tail: excluded from the smoke tier (pytest -m 'not slow')
pytestmark = pytest.mark.slow

def _state(model):
    return {k: jnp.asarray(v) for k, v in model.initial_state().items()}


def _run(model, geom, state, n):
    step = jax.jit(lambda s: model.step(s, geom))
    for _ in range(n):
        state = step(state)
    return state


class TestUntriggeredEquivalence:
    """A threshold no substep reaches => same trajectory as plain."""

    def test_court_2d(self):
        cfg = SimConfig(width=8, height=8, dt=0.1)
        geom = grid_geometry()
        plain = _run(Courtemanche(cfg), geom, _state(Courtemanche(cfg)), 20)
        adapt = _run(
            Courtemanche(cfg.replace(adaptive_dv=1e9)), geom,
            _state(Courtemanche(cfg)), 20,
        )
        for k in plain:
            # identical substeps; the cond changes XLA fusion context, so
            # allow ulp-level rounding (observed 1.5e-11 on Ca_i)
            np.testing.assert_allclose(
                plain[k], adapt[k], rtol=1e-6, atol=1e-8, err_msg=k
            )

    @pytest.mark.parametrize("model_cls,kw", [
        (Fenton4v, {}),
        (BeelerReuter, dict(cheby=True, skip=True)),
        (BeelerReuter, dict(cheby=True, skip=False)),
        (CourtemancheUltra, {}),
    ])
    def test_all_models(self, model_cls, kw):
        cfg = SimConfig(width=8, height=8, dt=0.1, **kw)
        geom = grid_geometry()
        plain = _run(model_cls(cfg), geom, _state(model_cls(cfg)), 5)
        adapt = _run(
            model_cls(cfg.replace(adaptive_dv=1e9)), geom,
            _state(model_cls(cfg)), 5,
        )
        for k in plain:
            np.testing.assert_allclose(
                plain[k], adapt[k], rtol=1e-6, atol=1e-8, err_msg=k
            )


class TestAlwaysTriggered:
    """A threshold every substep exceeds => the dt/2 clone's trajectory."""

    def test_court_matches_manual_half_dt(self):
        cfg = SimConfig(width=8, height=8, dt=0.1)
        geom = grid_geometry()
        m = Courtemanche(cfg)
        m_ad = Courtemanche(cfg.replace(adaptive_dv=1e-9, adaptive_depth=1))
        half = Courtemanche(cfg.replace(dt=0.05))
        s0 = _state(m)

        def commit(mm, s, keys):
            s1 = mm.solve(s, geom)
            return {**s, **{k: s1[k] for k in keys}}

        fast = m.fast_states
        slow = [k for k in s0 if k not in fast]
        exp = s0
        # substep 0: fast commit refines (2 half-dt solves: the ΔV bound
        # is exceeded); the slow commit does NOT (V is not among its
        # planes, and its finiteness/positivity acceptance passes), so it
        # stays one full-dt solve
        exp = commit(half, commit(half, exp, fast), fast)
        exp = commit(m, exp, slow)
        for _ in range(9):
            exp = commit(half, commit(half, exp, fast), fast)

        got = jax.jit(lambda s: m_ad.step(s, geom))(s0)
        for k in got:
            np.testing.assert_allclose(
                got[k], exp[k], rtol=1e-5, atol=1e-7, err_msg=k
            )


class TestStiffRescue:
    """Courtemanche 2D at dt=0.3: past the explicit diffusion stability
    limit (dt <~ 1/(4*diff) ~ 0.17) and the slow-plane Ca-release limit
    (slow dts are dt*10 = 3 ms).  Plain Euler reaches NaN within a few
    outer steps; the adaptive integrator (ΔV bound + finiteness +
    concentration positivity, refined to dt/4) stays finite and tracks
    the plain dt=0.075 trajectory."""

    def test_plain_blows_up_adaptive_survives(self):
        geom = grid_geometry()

        def run(dt, adaptive, n_outer):
            cfg = SimConfig(width=16, height=16, dt=dt,
                            adaptive_dv=adaptive)
            m = Courtemanche(cfg)
            s = _state(m)
            step = jax.jit(lambda s: m.step(s, geom))
            traj = []
            for i in range(n_outer):
                s = step(s)
                traj.append(float(s["V"][8, 8]))
                if not bool(jnp.isfinite(s["V"]).all()):
                    return i, traj
            return None, traj

        died_plain, _ = run(0.3, None, 12)
        assert died_plain is not None, "plain Euler should blow up at dt=0.3"

        died_adapt, traj = run(0.3, 25.0, 12)
        assert died_adapt is None, "adaptive integrator should stay finite"

        # tracks the refined-dt trajectory (coarse accepted substeps keep
        # ~mV-scale local error at dt=0.3; the point is stability + shape)
        _, fine = run(0.075, None, 48)
        fine4 = fine[3::4]
        err = max(abs(a - b) for a, b in zip(traj, fine4))
        assert err < 15.0, f"adaptive trajectory drifted {err} mV from dt/4"


class TestConfigValidation:
    def test_mutually_exclusive_with_dv_max(self):
        with pytest.raises(ValueError, match="mutually exclusive"):
            SimConfig(adaptive_dv=25.0, dv_max=25.0)

    def test_rejects_ab2(self):
        with pytest.raises(ValueError, match="ab2"):
            SimConfig(adaptive_dv=25.0, ab2=True)

    def test_rejects_spmd_mesh_only(self):
        """The shard_map path would read stale halos under local
        refinement, so forcing it raises; 'auto'/'gspmd' are allowed —
        GSPMD has no manual halos and the global acceptance predicate
        partitions (see TestAdaptiveGSPMD; VERDICT r3 #7 buried the
        untested 'adaptive can't shard' assumption)."""
        with pytest.raises(ValueError, match="shard_map"):
            SimConfig(adaptive_dv=25.0, mesh_shape=(2,), mesh_mode="spmd")
        SimConfig(adaptive_dv=25.0, mesh_shape=(2,))  # auto: ok
        SimConfig(adaptive_dv=25.0, mesh_shape=(2,), mesh_mode="gspmd")

    def test_rejects_bad_values(self):
        with pytest.raises(ValueError):
            SimConfig(adaptive_dv=-1.0)
        with pytest.raises(ValueError):
            SimConfig(adaptive_dv=25.0, adaptive_depth=0)


class TestAdaptiveGSPMD:
    """adaptive_dv partitions under GSPMD (VERDICT r3 #7): the
    acceptance predicate is a global reduction under lax.cond, XLA
    inserts the collectives, and there are no manual halos to go stale.
    Triggered and untriggered runs both match the unsharded trajectory."""

    def _run(self, sharded: bool):
        from fib_tf_tpu.engine.simulation import Simulation
        from fib_tf_tpu.models.luo_rudy import LuoRudy91

        # lr1 at dt=0.1 (5x its stable dt) GENUINELY triggers the
        # refinement on every upstroke substep (TestStiffRescue pattern)
        kw = dict(width=64, height=64, dt=0.1, dt_per_plot=1,
                  duration=4, diff=0.809, adaptive_dv=2.0,
                  adaptive_depth=3)
        if sharded:
            kw.update(mesh_shape=(8,), mesh_axes=("x",),
                      mesh_mode="gspmd")
        sim = Simulation(LuoRudy91(SimConfig(**kw))).define()
        assert sim._mesh is None
        assert (sim._sharding is not None) == sharded
        return sim.simulate()

    def test_triggered_matches_unsharded(self):
        want = self._run(False)
        got = self._run(True)
        np.testing.assert_allclose(
            got.state["V"], want.state["V"], rtol=2e-5, atol=2e-4
        )
        np.testing.assert_allclose(
            got.probes["v"], want.probes["v"], rtol=2e-5, atol=2e-5
        )


class TestEngineIntegration:
    def test_engine_runs_adaptive(self):
        from fib_tf_tpu.engine.simulation import Simulation

        cfg = SimConfig(width=16, height=16, dt=0.1, duration=4,
                        dt_per_plot=1, adaptive_dv=25.0)
        m = Fenton4v(cfg)
        sim = Simulation(m).define()
        out = sim.simulate()
        assert np.isfinite(out.probes["v"]).all()
