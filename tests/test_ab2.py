"""Adams-Bashforth-2 integrator (SimConfig.ab2).

The reference's native traits reserve 2x-VARIABLES parameter storage for
this scheme behind `#ifdef ADAMS_BASHFORTH` (reference ionic.h:15-19)
without implementing it; here it is a working opt-in for the
explicit-Euler state updates (all four Fenton planes; BR's V and Ca).
"""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models import (
    BeelerReuter,
    Courtemanche,
    Fenton4v,
    cell_geometry,
)
from fib_tf_tpu.utils import native


def solve_0d(model, state, n_substeps, record):
    geom = cell_geometry()
    state = {k: jnp.asarray(v, jnp.float32) for k, v in state.items()}

    def body(s, _):
        s = model.solve(s, geom)
        return s, s[record][0, 0]

    final, trace = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n_substeps)
    )(state)
    return final, np.asarray(trace)


def fenton_final_u(dt, ab2, t_ms=5.0):
    """u(t_ms) from a smooth (switch-free) window: u starts at 0.4 and
    rises toward 1 without crossing the sign()-step thresholds."""
    m = Fenton4v(SimConfig(width=8, height=8, dt=dt, duration=1, ab2=ab2))
    st = m.initial_state(s1=False)
    st["u"][:] = 0.4
    if ab2:
        st = m.bootstrap_ab2(st)
    final, _ = solve_0d(m, st, int(round(t_ms / dt)), "u")
    return float(final["u"][0, 0])


class TestFentonAB2:
    def test_much_more_accurate_than_euler(self):
        """At dt=0.1 the AB2 endpoint error vs a dt=0.001 reference is
        ~70x below Euler's (measured 1.1e-5 vs 7.7e-4); assert >=20x."""
        ref = fenton_final_u(0.001, ab2=False)
        err_euler = abs(fenton_final_u(0.1, ab2=False) - ref)
        err_ab2 = abs(fenton_final_u(0.1, ab2=True) - ref)
        assert err_ab2 < err_euler / 20.0

    def test_derivative_planes_ride_the_state(self):
        m = Fenton4v(SimConfig(width=8, height=8, dt=0.1, duration=1,
                               ab2=True))
        st = m.initial_state()
        assert set(st) == {"u", "v", "w", "s",
                           "_du_", "_dv_", "_dw_", "_ds_"}
        final, _ = solve_0d(m, st, 10, "u")
        assert np.isfinite(final["_du_"]).all()

    def test_matches_native_cell_sim(self):
        """cell_sim_fb --ab2 is an independent C++ AB2 implementation with
        the same bootstrap convention."""
        if not native.native_available():
            pytest.skip("native toolchain not buildable")
        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "fenton", "100", "0.1", "0.3", "--ab2"],
            capture_output=True, text=True, check=True,
        ).stdout
        u_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )
        m = Fenton4v(SimConfig(width=8, height=8, dt=0.1, duration=1,
                               ab2=True))
        st = m.initial_state(s1=False)
        st["u"][:] = 0.3
        st = m.bootstrap_ab2(st)
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in st.items()}

        def body(x, _):
            x = m.step(x, geom)  # 10 substeps = 1 ms
            return x, x["u"][0, 0]

        _, u_py = jax.jit(
            lambda x: jax.lax.scan(body, x, None, length=100)
        )(s)
        assert np.abs(u_native - np.asarray(u_py)).max() < 5e-3


class TestBeelerReuterAB2:
    def br_final_v(self, dt, ab2, t_ms=5.0):
        m = BeelerReuter(SimConfig(width=8, height=8, dt=dt, duration=1,
                                   ab2=ab2, cheby=False, skip=False))
        st = m.initial_state(s1=False)
        st["V"][:] = -30.0
        if ab2:
            st = m.bootstrap_ab2(st)
        final, _ = solve_0d(m, st, int(round(t_ms / dt)), "V")
        return float(final["V"][0, 0])

    def test_more_accurate_than_euler(self):
        """Gates stay first-order Rush-Larsen, so the win is bounded —
        measured ~2.7x on the V endpoint; assert >=1.5x."""
        ref = self.br_final_v(0.002, ab2=False)
        err_euler = abs(self.br_final_v(0.1, ab2=False) - ref)
        err_ab2 = abs(self.br_final_v(0.1, ab2=True) - ref)
        assert err_ab2 < err_euler / 1.5

    def test_matches_native_cell_sim(self):
        if not native.native_available():
            pytest.skip("native toolchain not buildable")
        exe = native.executable("cell_sim_fb")
        out = subprocess.run(
            [exe, "br", "100", "0.1", "-30", "--skip", "--ab2"],
            capture_output=True, text=True, check=True,
        ).stdout
        v_native = np.asarray(
            [float(l.split()[1]) for l in out.strip().splitlines()]
        )
        m = BeelerReuter(SimConfig(width=8, height=8, dt=0.1, duration=1,
                                   ab2=True, cheby=False, skip=True))
        st = m.initial_state(s1=False)
        st["V"][:] = -30.0
        st = m.bootstrap_ab2(st)
        geom = cell_geometry()
        s = {k: jnp.asarray(v) for k, v in st.items()}

        def body(x, _):
            x = m.step(x, geom)  # 5 substeps = 0.5 ms
            return x, x["V"][0, 0]

        _, v_py = jax.jit(
            lambda x: jax.lax.scan(body, x, None, length=200)
        )(s)
        # every other outer step lands on a millisecond boundary
        assert np.abs(v_native - np.asarray(v_py)[1::2]).max() < 1.0

    def test_tissue_runs_and_stays_close_to_euler(self):
        from fib_tf_tpu.engine import Simulation

        def run(ab2):
            cfg = SimConfig(width=32, height=32, dt=0.1, duration=20,
                            diff=0.809, ab2=ab2, cheby=True, skip=True)
            sim = Simulation(BeelerReuter(cfg)).define()
            return sim.simulate(warmup=False)

        r_euler, r_ab2 = run(False), run(True)
        assert np.isfinite(r_ab2.state["V"]).all()
        # same physics, slightly different integrator: a planar wave over
        # 20 ms should agree to a few mV
        assert np.abs(r_ab2.state["V"] - r_euler.state["V"]).max() < 5.0


def test_courtemanche_rejects_ab2():
    with pytest.raises(NotImplementedError):
        Courtemanche(SimConfig(width=8, height=8, ab2=True))


class TestAB2Sharded:
    """The _d*_ derivative planes ride the state pytree through both
    sharding paths; sharded must equal unsharded."""

    def _reference(self, model, n_steps):
        from fib_tf_tpu.models import grid_geometry

        geom = grid_geometry()
        s = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        out, _ = jax.jit(
            lambda st: jax.lax.scan(
                lambda x, _: (model.step(x, geom), None), st, None,
                length=n_steps)
        )(s)
        return {k: np.asarray(v) for k, v in out.items()}

    def test_gspmd_matches_single_device(self):
        from fib_tf_tpu.models import grid_geometry
        from fib_tf_tpu.parallel import make_mesh, shard_state

        model = Fenton4v(SimConfig(width=64, height=64, dt=0.1,
                                   duration=5, ab2=True))
        want = self._reference(model, 5)
        mesh = make_mesh()
        sharded = shard_state(model.initial_state(), mesh)
        geom = grid_geometry()
        got = jax.jit(
            lambda st: jax.lax.scan(
                lambda x, _: (model.step(x, geom), None), st, None,
                length=5)[0]
        )(sharded)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_shard_map_matches_single_device(self):
        from fib_tf_tpu.parallel import make_mesh, shard_state
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        model = BeelerReuter(SimConfig(width=64, height=64, dt=0.1,
                                       duration=5, ab2=True))
        want = self._reference(model, 5)
        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=5)
        got, probes = chunk(shard_state(model.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )
        assert np.isfinite(np.asarray(probes["v"])).all()


class TestAB2EngineIntegration:
    def _cfg(self, ab2):
        return SimConfig(width=32, height=32, dt=0.1, duration=10,
                         diff=0.809, ab2=ab2, cheby=True, skip=True)

    def test_resume_euler_checkpoint_into_ab2(self):
        from fib_tf_tpu.engine import Simulation

        r = Simulation(BeelerReuter(self._cfg(False))).define().simulate(
            warmup=False)
        sim = Simulation(BeelerReuter(self._cfg(True))).define(
            state=r.state)
        res = sim.simulate(warmup=False)
        assert np.isfinite(res.state["V"]).all()
        assert "_dV_" in res.state

    def test_resume_ab2_checkpoint_into_euler(self):
        from fib_tf_tpu.engine import Simulation

        r = Simulation(BeelerReuter(self._cfg(True))).define().simulate(
            warmup=False)
        assert "_dV_" in r.state
        sim = Simulation(BeelerReuter(self._cfg(False))).define(
            state=r.state)
        res = sim.simulate(warmup=False)
        assert np.isfinite(res.state["V"]).all()
        assert "_dV_" not in res.state

    def test_resume_unknown_plane_rejected(self):
        from fib_tf_tpu.engine import Simulation

        st = BeelerReuter(self._cfg(False)).initial_state()
        st["bogus"] = st["V"]
        with pytest.raises(ValueError, match="unknown planes"):
            Simulation(BeelerReuter(self._cfg(False))).define(state=st)

    def test_pacing_refreshes_derivative_planes(self):
        from fib_tf_tpu.engine import Simulation

        sim = Simulation(BeelerReuter(self._cfg(True))).define()
        sim.add_pace_op("s2", "luq", 10.0)
        st = sim._device_state()
        paced = sim.fire_on(st, "s2")
        # the derivative planes must equal a fresh bootstrap of the
        # post-stimulus state, not the pre-stimulus values
        want = sim.model.bootstrap_ab2(
            {k: np.asarray(v) for k, v in paced.items()}
        )
        np.testing.assert_allclose(
            np.asarray(paced["_dV_"]), want["_dV_"], rtol=1e-6, atol=1e-6
        )
        assert not np.allclose(np.asarray(paced["_dV_"]),
                               np.asarray(st["_dV_"]))

    def test_state_keys_match_initial_state(self):
        from fib_tf_tpu.models import CourtemancheUltra

        for model in (
            Fenton4v(self._cfg(False)),
            Fenton4v(self._cfg(True)),
            BeelerReuter(self._cfg(False)),
            BeelerReuter(self._cfg(True)),
            Courtemanche(SimConfig(width=8, height=8)),
            CourtemancheUltra(SimConfig(width=8, height=8,
                                        ultra_slow=True)),
        ):
            assert model.state_keys() == tuple(
                sorted(model.initial_state(s1=False).keys())
            ), model


def test_cheby_fold_cadence_guard():
    """skip+cheby_fold bakes dt*5 into the slow-gate multiplier; driving
    solve(n=1) per substep would silently advance slow gates 5x (APD90
    202 -> 71 ms measured) — it must raise instead."""
    from fib_tf_tpu.models import cell_geometry

    m = BeelerReuter(SimConfig(width=8, height=8, dt=0.1, duration=1,
                               cheby=True, skip=True))
    st = {k: jnp.asarray(v) for k, v in m.initial_state(s1=False).items()}
    with pytest.raises(ValueError, match="cheby_fold baked"):
        m.solve(st, cell_geometry(), n=1)
    # the step() cadence (n=5 then frozen) stays valid
    out = m.step(st, cell_geometry())
    assert np.isfinite(np.asarray(out["V"])).all()
