"""Multi-chip tests on the virtual 8-device CPU mesh: sharded == unsharded
(SURVEY.md §4d), for both the GSPMD path and the explicit shard_map halo
path."""

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.models import Fenton4v, BeelerReuter, grid_geometry
from fib_tf_tpu.parallel import make_mesh, plane_sharding, shard_state
from fib_tf_tpu.parallel.spmd import make_spmd_chunk


import pytest

# long tail: excluded from the smoke tier (pytest -m 'not slow')
pytestmark = pytest.mark.slow

def cfg(**kw):
    base = dict(width=64, height=64, dt=0.1, dt_per_plot=10,
                diff=1.5, duration=5)
    base.update(kw)
    return SimConfig(**base)


def reference_run(model, n_steps, phase=None, state=None):
    geom = grid_geometry(phase)
    s = {k: jnp.asarray(v)
         for k, v in (state or model.initial_state()).items()}

    def body(st, _):
        return model.step(st, geom), None

    out, _ = jax.jit(
        lambda st: jax.lax.scan(body, st, None, length=n_steps)
    )(s)
    return {k: np.asarray(v) for k, v in out.items()}


class TestGSPMD:
    def test_row_sharded_matches_single_device(self):
        c = cfg()
        model = Fenton4v(c)
        want = reference_run(model, 5)

        mesh = make_mesh()  # 8 devices, 1D
        sharded = shard_state(model.initial_state(), mesh)
        geom = grid_geometry()

        def body(st, _):
            return model.step(st, geom), None

        got = jax.jit(
            lambda st: jax.lax.scan(body, st, None, length=5)[0]
        )(sharded)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_2d_mesh(self):
        c = cfg()
        model = Fenton4v(c)
        want = reference_run(model, 3)
        mesh = make_mesh(shape=(4, 2))
        sharded = shard_state(model.initial_state(), mesh)
        geom = grid_geometry()
        got = jax.jit(
            lambda st: jax.lax.scan(
                lambda s, _: (model.step(s, geom), None), st, None, length=3
            )[0]
        )(sharded)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_config_driven_mesh(self):
        """SimConfig.mesh_shape wires GSPMD sharding without explicit
        Simulation arguments."""
        c = cfg(duration=3).replace(mesh_shape=(8,), mesh_axes=("x",))
        sim = Simulation(Fenton4v(c)).define()
        res = sim.simulate()
        ref = Simulation(Fenton4v(cfg(duration=3))).define().simulate()
        np.testing.assert_allclose(
            res.state["u"], ref.state["u"], rtol=1e-5, atol=1e-6
        )

    def test_engine_with_sharding(self):
        c = cfg(duration=5)
        mesh = make_mesh()
        sim = Simulation(Fenton4v(c), sharding=plane_sharding(mesh))
        sim.define()
        res = sim.simulate()
        ref = Simulation(Fenton4v(c)).define().simulate()
        np.testing.assert_allclose(
            res.state["u"], ref.state["u"], rtol=1e-5, atol=1e-6
        )

    def test_ecg_stream_with_sharding(self):
        # the far-field pseudo-ECG reduction becomes a GSPMD psum
        c = cfg(duration=5)
        mesh = make_mesh()
        sim = Simulation(Fenton4v(c), sharding=plane_sharding(mesh))
        sim.add_ecg_electrode(c.width // 2, c.height // 2, z=4.0)
        sim.define()
        res = sim.simulate()
        ref = Simulation(Fenton4v(c))
        ref.add_ecg_electrode(c.width // 2, c.height // 2, z=4.0)
        ref.define()
        refr = ref.simulate()
        np.testing.assert_allclose(
            res.probes["ecg"], refr.probes["ecg"], rtol=1e-4, atol=1e-5
        )


class TestShardMapHalo:
    def test_matches_single_device(self):
        c = cfg()
        model = Fenton4v(c)
        want = reference_run(model, 5)

        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=5)
        sharded = shard_state(model.initial_state(), mesh)
        got, probes = chunk(sharded)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )
        assert probes["v"].shape == (5,)

    def test_with_phase_field(self):
        from fib_tf_tpu.ops import stencil as st

        c = cfg()
        model = Fenton4v(c)
        phase = st.add_hole_to_phase_field(None, 64, 64, 32, 32, 10)
        want = reference_run(model, 5, phase=phase)

        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=5, phase=phase)
        sharded = shard_state(model.initial_state(), mesh)
        got, _ = chunk(sharded)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_probe_matches_and_egm(self):
        from fib_tf_tpu.ops import stencil as st

        c = cfg()
        model = Fenton4v(c)
        masks = [st.gaussian_mask(64, 64, 40, 32, 5)]

        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=3, egm_masks=masks)
        sharded = shard_state(model.initial_state(), mesh)
        got, probes = chunk(sharded)
        assert probes["egm"].shape == (3, 1)

        # reference: host-side masked mean on the gathered image
        want = reference_run(model, 1)
        model_img = (want["u"] - model.min_v) / (model.max_v - model.min_v)
        np.testing.assert_allclose(
            float(probes["egm"][0, 0]),
            float(np.mean(model_img * masks[0])),
            rtol=1e-5, atol=1e-6,
        )

    def test_engine_spmd_mode(self):
        """Simulation(mesh=...) drives the whole run through the shard_map
        chunk, matching the single-device engine."""
        c = cfg(duration=5)
        model_kwargs = dict()
        mesh = make_mesh()
        sim = Simulation(Fenton4v(c), mesh=mesh)
        sim.add_electrode(40, 32, radius=4)
        sim.define()
        res = sim.simulate()

        ref = Simulation(Fenton4v(c))
        ref.add_electrode(40, 32, radius=4)
        ref.define()
        want = ref.simulate()
        np.testing.assert_allclose(
            res.state["u"], want.state["u"], rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            res.probes["egm"], want.probes["egm"], rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            res.probes["v"], want.probes["v"], rtol=1e-4, atol=1e-6
        )

    def test_beeler_reuter_sharded(self):
        c = cfg(cheby=True, skip=True)
        model = BeelerReuter(c)
        want = reference_run(model, 3)
        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=3)
        got, _ = chunk(shard_state(model.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_2d_mesh_matches_single_device(self):
        """Explicit 2D (4 rows x 2 cols) shard_map halo exchange — row,
        column, and diagonal-corner ghosts — matches the single-device
        run (VERDICT r1 #7)."""
        from fib_tf_tpu.ops import stencil as st

        c = cfg()
        model = Fenton4v(c)
        phase = st.add_hole_to_phase_field(None, 64, 64, 32, 32, 10)
        want = reference_run(model, 5, phase=phase)

        mesh = make_mesh(shape=(4, 2))
        masks = [st.gaussian_mask(64, 64, 40, 32, 5)]
        chunk = make_spmd_chunk(model, mesh, length=5, phase=phase,
                                egm_masks=masks)
        got, probes = chunk(shard_state(model.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )
        assert probes["v"].shape == (5,)
        assert probes["egm"].shape == (5, 1)
        # probe pixel [20, 32] sits on shard (1, 1) — the masked psum
        # must still produce the phase-masked single-device value
        img = (want["u"] - model.min_v) / (model.max_v - model.min_v)
        np.testing.assert_allclose(
            float(probes["v"][-1]), float(img[20, 32] * phase[20, 32]),
            rtol=1e-5, atol=1e-6,
        )

    def test_2d_mesh_beeler_reuter(self):
        c = cfg(diff=0.809, cheby=True, skip=True)
        model = BeelerReuter(c)
        want = reference_run(model, 3)
        mesh = make_mesh(shape=(2, 4))
        chunk = make_spmd_chunk(model, mesh, length=3)
        got, _ = chunk(shard_state(model.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6
            )

    def test_2d_engine_mode(self):
        c = cfg(duration=5)
        mesh = make_mesh(shape=(4, 2))
        sim = Simulation(Fenton4v(c), mesh=mesh).define()
        res = sim.simulate()
        want = Simulation(Fenton4v(c)).define().simulate()
        np.testing.assert_allclose(
            res.state["u"], want.state["u"], rtol=1e-5, atol=1e-6
        )

    def test_wide_halo_2d_matches(self):
        """2D wide-halo: one K-row + K-column (with KxK corners)
        exchange per outer step == single device, including a phase
        field and the global edges."""
        from fib_tf_tpu.ops import stencil as st

        # (2, 2) mesh: 64 rows x 64 cols per shard >= K=10 in both dims
        c = cfg(height=128, width=128)
        model = Fenton4v(c)
        for phase in (None,
                      st.add_hole_to_phase_field(None, 128, 128, 64, 64, 10)):
            want = reference_run(model, 3, phase=phase)
            import jax
            mesh = make_mesh(shape=(2, 2), devices=jax.devices()[:4])
            chunk = make_spmd_chunk(model, mesh, length=3, phase=phase,
                                    wide_halo=True)
            got, probes = chunk(shard_state(model.initial_state(), mesh))
            for k in want:
                np.testing.assert_allclose(
                    np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6,
                    err_msg=f"phase={phase is not None} {k}",
                )
            assert probes["v"].shape == (3,)

    def test_wide_halo_2d_too_narrow_raises(self):
        import pytest

        # 64 cols / 2 col-shards = 32 >= 10 ok, but rows 64/8 = 8 < 10
        model = Fenton4v(cfg())
        mesh = make_mesh(shape=(8, 1))
        with pytest.raises(ValueError, match="rows"):
            Simulation(model, mesh=mesh, wide_halo=True)

    def test_wide_halo_too_few_rows_engine_error(self):
        import pytest

        # 64 rows / 8 shards = 8 rows < dt_per_step=10 for fenton
        model = Fenton4v(cfg())
        with pytest.raises(ValueError, match="rows"):
            Simulation(model, mesh=make_mesh(), wide_halo=True)

    def test_wide_halo_matches(self):
        """One K-row exchange per outer step == per-substep exchanges ==
        single device, including phase fields and global edges."""
        from fib_tf_tpu.ops import stencil as st

        # 128 rows over 8 shards = 16 rows/shard >= K ghost rows
        for model_cls, extra, with_phase in [
            (Fenton4v, {}, False),
            (Fenton4v, {}, True),
            (BeelerReuter, dict(diff=0.809, cheby=True, skip=True), False),
        ]:
            c = cfg(height=128, **extra)
            model = model_cls(c)
            phase = (
                st.add_hole_to_phase_field(None, 128, 64, 32, 64, 10)
                if with_phase else None
            )
            want = reference_run(model, 3, phase=phase)
            mesh = make_mesh()
            chunk = make_spmd_chunk(
                model, mesh, length=3, phase=phase, wide_halo=True
            )
            got, probes = chunk(shard_state(model.initial_state(), mesh))
            for k in want:
                np.testing.assert_allclose(
                    np.asarray(got[k]), want[k], rtol=1e-6, atol=1e-6,
                    err_msg=f"{model.name} phase={with_phase} {k}",
                )
            assert probes["v"].shape == (3,)


class TestShardedAnisotropy:
    """fiber tensor on the wide-halo shard_map path == single-device
    anisotropic run."""

    def test_wide_halo_aniso_matches(self):
        from fib_tf_tpu.models import grid_geometry as gg
        from fib_tf_tpu.ops import stencil as st

        c = SimConfig(width=64, height=128, dt=0.1, duration=5, diff=1.5,
                      fiber_angle=0.6, fiber_ratio=0.3)
        model = Fenton4v(c)
        fiber = st.fiber_tensor(0.6, 0.3)
        geom = gg(None, 0.6, 0.3)
        s0 = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        want, _ = jax.jit(
            lambda x: jax.lax.scan(
                lambda y, _: (model.step(y, geom), None), x, None,
                length=2)
        )(s0)
        mesh = make_mesh()
        chunk = make_spmd_chunk(model, mesh, length=2, wide_halo=True,
                                fiber=fiber)
        got, _ = chunk(shard_state(model.initial_state(), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]),
                rtol=1e-5, atol=1e-5, err_msg=k,
            )

    def test_fiber_ecg_matches(self):
        """far-field pseudo-ECG on a fiber run rides the shard_map mesh
        (the sharded probe evaluates the tensor operator — incl. the
        phase correction — over a 1-ring ghost extension; r4 closed this
        last mesh observable gap): sharded == unsharded stream."""
        def build(**kw):
            c = SimConfig(width=64, height=128, dt=0.1, duration=5,
                          dt_per_plot=10, diff=1.5,
                          fiber_angle=0.6, fiber_ratio=0.3)
            sim = Simulation(Fenton4v(c), **kw)
            sim.add_hole_to_phase_field(32, 64, 10)
            sim.add_ecg_electrode(32, 64, z=4.0)
            sim.add_ecg_electrode(10, 100, z=0.0)
            return sim.define().simulate()

        want = build()
        got = build(mesh=make_mesh(), wide_halo=True)
        np.testing.assert_allclose(
            got.probes["ecg"], want.probes["ecg"], rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            got.state["u"], want.state["u"], rtol=1e-5, atol=1e-6
        )

    def test_fiber_requires_wide_halo(self):
        import pytest
        from fib_tf_tpu.ops import stencil as st

        model = Fenton4v(cfg())
        with pytest.raises(ValueError, match="wide_halo"):
            make_spmd_chunk(model, make_mesh(), length=2,
                            fiber=st.fiber_tensor(0.5, 0.5))

    def test_engine_mesh_aniso_requires_wide_halo(self):
        import pytest

        c = cfg(fiber_angle=0.5, fiber_ratio=0.5)
        with pytest.raises(ValueError, match="wide_halo"):
            Simulation(Fenton4v(c), mesh=make_mesh())


class TestMeshModeRouting:
    """SimConfig.mesh_shape + mesh_mode reach the intended path
    (VERDICT r3 #1): 'auto' lands on shard_map wide-halo when the
    model/grid qualify, falls back to GSPMD with a warning naming the
    disqualifier, and 'spmd'/'gspmd' force one."""

    def test_auto_routes_to_spmd_wide_halo(self):
        import pytest

        c = cfg(height=128, duration=3).replace(
            mesh_shape=(8,), mesh_axes=("x",))
        sim = Simulation(Fenton4v(c))
        assert sim._mesh is not None and sim._wide_halo
        res = sim.define().simulate()
        want = Simulation(Fenton4v(cfg(height=128, duration=3))
                          ).define().simulate()
        np.testing.assert_allclose(
            res.state["u"], want.state["u"], rtol=2e-5, atol=1e-5
        )

    def test_auto_falls_back_to_gspmd_with_warning(self):
        import pytest

        # 64 rows / 8 shards = 8 < fenton's K=10 wide halo
        c = cfg(duration=3).replace(mesh_shape=(8,), mesh_axes=("x",))
        with pytest.warns(UserWarning, match="falling back to the GSPMD"):
            sim = Simulation(Fenton4v(c))
        assert sim._mesh is None and sim._sharding is not None

    def test_spmd_forced_raises_when_disqualified(self):
        import pytest

        c = cfg(duration=3).replace(
            mesh_shape=(8,), mesh_axes=("x",), mesh_mode="spmd")
        with pytest.raises(ValueError, match="mesh_mode='spmd'"):
            Simulation(Fenton4v(c))

    def test_gspmd_forced(self):
        c = cfg(height=128, duration=3).replace(
            mesh_shape=(8,), mesh_axes=("x",), mesh_mode="gspmd")
        sim = Simulation(Fenton4v(c))
        assert sim._mesh is None and sim._sharding is not None

    def test_adaptive_routes_to_gspmd(self):
        import pytest

        c = cfg(height=128, duration=3).replace(
            mesh_shape=(8,), mesh_axes=("x",), adaptive_dv=5.0)
        with pytest.warns(UserWarning, match="adaptive_dv"):
            sim = Simulation(Fenton4v(c))
        assert sim._mesh is None and sim._sharding is not None

    def test_adaptive_spmd_forced_raises_in_config(self):
        import pytest

        with pytest.raises(ValueError, match="adaptive_dv"):
            cfg(height=128).replace(
                mesh_shape=(8,), mesh_mode="spmd", adaptive_dv=5.0)


class TestShardedObservables:
    """Probe parity on the shard_map mesh (VERDICT r3 #5): trend, ECG,
    ultra means, and the live rotor census match the unsharded run."""

    def _court(self, mesh=False, rotor=False, ultra=False):
        from fib_tf_tpu.models import MODEL_REGISTRY

        kw = dict(width=64, height=128, dt=0.1, dt_per_plot=10,
                  diff=0.809, duration=3, rotor_probe=rotor,
                  ultra_slow=ultra)
        if mesh:
            kw.update(mesh_shape=(8,), mesh_axes=("x",))
        c = SimConfig(**kw)
        name = "court_ultra" if ultra else "court"
        sim = Simulation(MODEL_REGISTRY[name](c))
        sim.add_hole_to_phase_field(20, 64, 6)
        sim.add_electrode(40, 64, 5)
        sim.add_ecg_electrode(30, 60, 4.0)
        sim.define()
        return sim

    def test_court_trend_egm_ecg_rotor_match(self):
        sim = self._court(mesh=True, rotor=True)
        assert sim._mesh is not None and sim._wide_halo
        res = sim.simulate()
        want = self._court(rotor=True).simulate()
        assert sorted(res.probes) == sorted(want.probes)
        for k in ("v", "trend", "egm"):
            np.testing.assert_allclose(
                res.probes[k], want.probes[k], rtol=2e-5, atol=2e-5,
                err_msg=k,
            )
        np.testing.assert_allclose(
            res.probes["ecg"], want.probes["ecg"], rtol=1e-4, atol=1e-4
        )
        # plaquette charges are exact small integers: counts match exactly
        np.testing.assert_array_equal(
            res.probes["rotors"], want.probes["rotors"]
        )

    def test_ultra_means_match(self):
        sim = self._court(mesh=True, ultra=True)
        res = sim.simulate()
        want = self._court(ultra=True).simulate()
        np.testing.assert_allclose(
            res.probes["ultra"], want.probes["ultra"],
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            res.probes["trend"], want.probes["trend"],
            rtol=2e-5, atol=2e-5,
        )

    def test_rotor_census_nonzero_2d_mesh(self):
        """A synthetic vortex (sin/cos phase pair around a center) has a
        guaranteed ±1 winding; the sharded census (2D mesh, ghost
        row+col+corner exchange) must count exactly what the single-chip
        stencil.rotor_metrics counts."""
        from fib_tf_tpu.ops import stencil
        from fib_tf_tpu.parallel.spmd import (
            ROTOR_BUF, ROTOR_IDX, make_spmd_chunk,
        )

        h, w = 128, 64
        c = SimConfig(width=w, height=h, dt=0.1, dt_per_plot=10,
                      diff=1.5, duration=2)
        model = Fenton4v(c)
        yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32),
                             indexing="ij")
        phi = np.arctan2(yy - h / 2, xx - w / 2)
        base = model.initial_state(s1=False)
        base["u"] = (0.5 + 0.45 * np.sin(phi)).astype(np.float32)
        buf = (0.5 + 0.45 * np.cos(phi)).astype(np.float32)[None]
        phase = stencil.add_hole_to_phase_field(None, h, w, 20, 64, 6)

        # single-chip reference: one step, then the census vs the ring
        geom = grid_geometry(phase)
        s = {k: jnp.asarray(v) for k, v in base.items()}
        ref_after = jax.jit(lambda st: model.step(st, geom))(s)
        want = np.asarray(stencil.rotor_metrics(
            model.image(ref_after), jnp.asarray(buf[0]), v_star=0.5,
            phase=jnp.asarray(phase),
        ))
        assert want[0] > 0  # the vortex is actually counted

        mesh = make_mesh(shape=(4, 2))
        chunk = make_spmd_chunk(model, mesh, length=1, phase=phase,
                                rotor=(1, 0.5))
        state = {**{k: jnp.asarray(v) for k, v in base.items()},
                 ROTOR_BUF: jnp.asarray(buf),
                 ROTOR_IDX: jnp.zeros((), jnp.int32)}
        out, probes = chunk(state)
        np.testing.assert_array_equal(
            np.asarray(probes["rotors"][0]), want
        )
        for k in base:
            np.testing.assert_allclose(
                np.asarray(out[k]), np.asarray(ref_after[k]),
                rtol=2e-5, atol=1e-5, err_msg=k,
            )
