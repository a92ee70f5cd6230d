"""Spatial heterogeneity — per-pixel diffusion maps and parameter planes.

VERDICT r4 #1: the reference's only spatial structure was the binary
phase-field hole (ionic.py:83-105).  Two generalizations land here:

  * the per-pixel RELATIVE diffusion map (fibrosis) — operator
    identities (dmap ≡ 1 reduces EXACTLY to the existing phase-field
    forms on every implementation: stencil / block-geometry masks /
    halo exchange), engine == model-step and sharded == unsharded
    parity, and the sqrt(d) CV physics;
  * per-pixel PARAMETER planes riding the state dict as _p_* keys
    (models/base.set_het) — tp06's transmural epi/endo/M wedge and
    court's regional chronic-AF remodeling — same parity ladder, plus
    the identity that a CONSTANT plane reproduces the corresponding
    global flag bitwise.

The sharded/physics cases are slow-tier; everything else is smoke-tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.engine import Simulation
from fib_tf_tpu.models import BeelerReuter, Fenton4v, grid_geometry
from fib_tf_tpu.ops import stencil


def pad1(a):
    return np.pad(np.asarray(a, np.float32), 1, mode="reflect")


def rand_field(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32)


def smooth_dmap(h, w, seed=3, lo=0.3):
    """A smooth heterogeneous map in [lo, 1] (cosine bump)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = lo + (1 - lo) * 0.5 * (
        1 + np.cos(2 * np.pi * xx / w) * np.sin(2 * np.pi * yy / h)
    ) / 1.0
    return np.clip(d, lo, 1.0).astype(np.float32)


class TestOperator:
    def test_dmap_of_ones_is_identity(self):
        x = jnp.asarray(rand_field((16, 24), 0))
        ones = np.ones((16, 24), np.float32)
        base = stencil.laplace(x)
        het = stencil.laplace(x, dmap_padded=jnp.asarray(pad1(ones)))
        np.testing.assert_array_equal(np.asarray(het), np.asarray(base))

    def test_dmap_of_ones_with_phase_matches_phase_form(self):
        x = jnp.asarray(rand_field((16, 16), 1))
        phase = stencil.add_hole_to_phase_field(None, 16, 16, 8, 8, 3)
        ones = np.ones((16, 16), np.float32)
        base = stencil.laplace(x, phase_padded=jnp.asarray(pad1(phase)))
        het = stencil.laplace(
            x, phase_padded=jnp.asarray(pad1(phase)),
            dmap_padded=jnp.asarray(pad1(ones)),
        )
        np.testing.assert_allclose(np.asarray(het), np.asarray(base),
                                   rtol=1e-6, atol=1e-6)

    def test_uniform_dmap_scales_like_diff(self):
        """In uniform-d tissue the operator is exactly d x the base one
        (∇d = 0 kills the correction) — a uniform map == scaled diff."""
        x = jnp.asarray(rand_field((12, 20), 2))
        d = np.full((12, 20), 0.37, np.float32)
        het = stencil.laplace(x, dmap_padded=jnp.asarray(pad1(d)))
        np.testing.assert_allclose(
            np.asarray(het), 0.37 * np.asarray(stencil.laplace(x)),
            rtol=1e-5, atol=1e-6,
        )

    @staticmethod
    def _block(h, w, cols=False, **kw):
        """block_geometry on an un-extended block: global row (and, with
        `cols`, column) indices of the true grid."""
        rg = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
        if not cols:
            return stencil.block_geometry(rg, h, **kw)
        cg = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)
        return stencil.block_geometry(rg, h, cg, w, **kw)

    def test_block_geometry_2d_matches_stencil(self):
        """The 2D-mesh form (global column masks) with a dmap == the
        stencil form, Laplacian and boundary rewrite."""
        x = jnp.asarray(rand_field((16, 24), 4))
        d = smooth_dmap(16, 24)
        geom = self._block(16, 24, cols=True, dmap_ext=jnp.asarray(d))
        want = stencil.laplace(x, dmap_padded=jnp.asarray(pad1(d)))
        np.testing.assert_allclose(np.asarray(geom.laplace(x)),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(geom.enforce_boundary(x)),
            np.asarray(stencil.enforce_boundary(x)))

    def test_block_geometry_with_phase_matches_stencil(self):
        x = jnp.asarray(rand_field((16, 16), 5))
        d = smooth_dmap(16, 16)
        phase = stencil.add_hole_to_phase_field(None, 16, 16, 8, 8, 3)
        want = stencil.laplace(
            x, phase_padded=jnp.asarray(pad1(phase)),
            dmap_padded=jnp.asarray(pad1(d)),
        )
        geom = self._block(16, 16, phase_ext=jnp.asarray(phase),
                           dmap_ext=jnp.asarray(d))
        np.testing.assert_allclose(np.asarray(geom.laplace(x)),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_block_geometry_anisotropic_matches_stencil(self):
        x = jnp.asarray(rand_field((16, 24), 6))
        d = smooth_dmap(16, 24)
        fiber = stencil.fiber_tensor(0.5, 0.3)
        want = stencil.anisotropic_laplace(
            x, *fiber, dmap_padded=jnp.asarray(pad1(d))
        )
        geom = self._block(16, 24, cols=True, fiber=fiber,
                           dmap_ext=jnp.asarray(d))
        np.testing.assert_allclose(np.asarray(geom.laplace(x)),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_block_geometry_matches_stencil(self):
        """block_geometry (the wide-halo form) with a dmap on an
        un-extended block == the stencil form."""
        block_geometry = stencil.block_geometry

        h, w = 16, 24
        x = jnp.asarray(rand_field((h, w), 7))
        d = jnp.asarray(smooth_dmap(h, w))
        rg = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
        geom = block_geometry(rg, h, dmap_ext=d)
        want = stencil.laplace(x, dmap_padded=jnp.asarray(
            pad1(np.asarray(d))))
        np.testing.assert_allclose(
            np.asarray(geom.laplace(x)), np.asarray(want),
            rtol=1e-4, atol=1e-4,
        )

    def test_fibrosis_map_properties(self):
        d = stencil.fibrosis_map(64, 64, density=0.3, strength=0.8, seed=1)
        assert d.shape == (64, 64)
        assert set(np.unique(d)).issubset({np.float32(0.2), np.float32(1.0)})
        frac = float((d < 1.0).mean())
        assert 0.15 < frac < 0.45  # patch quantization tolerance
        np.testing.assert_array_equal(
            d, stencil.fibrosis_map(64, 64, density=0.3, strength=0.8,
                                    seed=1))
        assert not np.array_equal(
            d, stencil.fibrosis_map(64, 64, density=0.3, strength=0.8,
                                    seed=2))


class TestDiffusionMapValidation:
    def test_set_diffusion_map_validation(self):
        sim = Simulation(Fenton4v(SimConfig(width=32, height=32,
                                            duration=1)))
        with pytest.raises(ValueError, match="shape"):
            sim.set_diffusion_map(np.ones((16, 16), np.float32))
        with pytest.raises(ValueError, match="finite"):
            sim.set_diffusion_map(np.full((32, 32), np.nan))
        sim.define()
        with pytest.raises(AssertionError):
            sim.set_diffusion_map(np.ones((32, 32), np.float32))


class TestHetPlaneValidation:
    """models/base.set_het and the SimConfig cell_type plumbing."""

    def test_unknown_param_rejected(self):
        from fib_tf_tpu.models import TenTusscher06

        m = TenTusscher06(SimConfig(width=8, height=8, dt=0.02,
                                    duration=1))
        with pytest.raises(ValueError, match="no heterogeneous"):
            m.set_het(g_na=np.ones((8, 8), np.float32))

    def test_shape_and_finiteness_rejected(self):
        from fib_tf_tpu.models import Courtemanche

        m = Courtemanche(SimConfig(width=8, height=8, duration=1))
        with pytest.raises(ValueError, match="shape"):
            m.set_het(chronic=np.ones((4, 4), np.float32))
        with pytest.raises(ValueError, match="finite"):
            m.set_het(chronic=np.full((8, 8), np.nan))

    def test_set_het_none_removes(self):
        from fib_tf_tpu.models import Courtemanche

        m = Courtemanche(SimConfig(width=8, height=8, duration=1))
        m.set_het(chronic=np.ones((8, 8), np.float32))
        assert m.het_keys() == ("_p_chronic",)
        m.set_het(chronic=None)
        assert m.het_keys() == ()

    def test_config_validation(self):
        with pytest.raises(ValueError, match="cell_type"):
            SimConfig(width=8, height=8, duration=1, cell_type="apex")
        with pytest.raises(ValueError, match="bands"):
            SimConfig(width=8, height=8, duration=1,
                      cell_type_bands=(0.7, 0.3))

    def test_transmural_config_attaches_planes(self):
        from fib_tf_tpu.models import TenTusscher06

        cfg = SimConfig(width=32, height=8, dt=0.02, duration=1,
                        cell_type="transmural")
        m = TenTusscher06(cfg)
        assert set(m.het_keys()) == {"_p_endo", "_p_g_ks", "_p_g_to"}
        st = m.initial_state(s1=False)
        assert set(m.state_keys()) == set(st.keys())
        # endo band (x < 0.25*32 = 8) carries the endo conductances and
        # the endo s-gate rest steady state
        assert st["_p_g_to"][0, 0] == np.float32(0.073)
        assert st["_p_g_to"][0, 16] == np.float32(0.294)
        assert st["s"][0, 0] != st["s"][0, 16]
        uniform = TenTusscher06(SimConfig(width=32, height=8, dt=0.02,
                                          duration=1, cell_type="m"))
        assert uniform.het_keys() == ()
        assert uniform.cell_type == "m"


class TestHetPlaneParity:
    """Per-pixel parameter planes: the engine's scan == a loop of the
    model step, and a CONSTANT plane reproduces the corresponding global
    flag bitwise."""

    @staticmethod
    def _engine_vs_step(m):
        geom = grid_geometry()
        want = {k: jnp.asarray(v) for k, v in m.initial_state().items()}
        step = jax.jit(lambda s: m.step(s, geom))
        for _ in range(m.cfg.samples(m.dt_per_step)):
            want = step(want)
        got = Simulation(m).define().simulate().state
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(
                got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                err_msg=k,
            )

    @pytest.mark.parametrize("skip", [False, True])
    def test_tp06_transmural_engine_matches_step(self, skip):
        from fib_tf_tpu.models import TenTusscher06

        self._engine_vs_step(TenTusscher06(SimConfig(
            width=32, height=32, dt=0.02, duration=0.4, dt_per_plot=10,
            cell_type="transmural", skip=skip)))

    def test_court_chronic_plane_engine_matches_step(self):
        from fib_tf_tpu.models import Courtemanche

        m = Courtemanche(SimConfig(width=32, height=32, duration=2,
                                   dt_per_plot=10))
        plane = np.zeros((32, 32), np.float32)
        plane[:, 16:] = 1.0
        plane[:, 8:16] = 0.5     # gray-zone border
        m.set_het(chronic=plane)
        self._engine_vs_step(m)

    def test_court_constant_plane_equals_global_flag(self):
        """chronic ≡ 1 plane == cfg.chronic=True bitwise; ≡ 0 ==
        chronic=False (the plane generalizes the reference's global
        flag, court.py:193-194, 218 — identical where constant)."""
        from fib_tf_tpu.models import Courtemanche

        geom = grid_geometry()
        for val, flag in ((1.0, True), (0.0, False)):
            mf = Courtemanche(SimConfig(width=16, height=16, duration=1,
                                        chronic=flag))
            mp = Courtemanche(SimConfig(width=16, height=16, duration=1,
                                        chronic=not flag))
            mp.set_het(chronic=np.full((16, 16), val, np.float32))
            sf = {k: jnp.asarray(v) for k, v in mf.initial_state().items()}
            sp = {k: jnp.asarray(v) for k, v in mp.initial_state().items()}
            of = mf.step(sf, geom)
            op = mp.step(sp, geom)
            for k in of:
                np.testing.assert_array_equal(
                    np.asarray(op[k]), np.asarray(of[k]), err_msg=k)

    def test_tp06_constant_planes_equal_uniform_endo(self):
        """Full-grid endo planes == cell_type='endo' bitwise (w = 1
        blend selects the endo forms exactly)."""
        from fib_tf_tpu.models import TenTusscher06
        from fib_tf_tpu.models.tp06 import CELL_TYPES

        geom = grid_geometry()
        cfg = SimConfig(width=16, height=16, dt=0.02, duration=1)
        mu = TenTusscher06(cfg.replace(cell_type="endo"))
        mp = TenTusscher06(cfg)
        g_to, g_ks = CELL_TYPES["endo"]
        ones = np.ones((16, 16), np.float32)
        mp.set_het(g_to=g_to * ones, g_ks=g_ks * ones, endo=ones)
        su = {k: jnp.asarray(v) for k, v in mu.initial_state().items()}
        sp = {k: jnp.asarray(v) for k, v in mp.initial_state().items()}
        np.testing.assert_array_equal(np.asarray(sp["s"]),
                                      np.asarray(su["s"]))
        ou = mu.step(su, geom)
        op = mp.step(sp, geom)
        for k in ou:
            np.testing.assert_array_equal(
                np.asarray(op[k]), np.asarray(ou[k]), err_msg=k)


@pytest.mark.slow
class TestHetPlaneSharded:
    """sharded == unsharded for the _p_* parameter planes on the mesh
    paths the engine routes to (the ghost rows of a CONSTANT plane
    delivered by ppermute are exactly the plane's own values)."""

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(wide_halo=True),
    ])
    def test_tp06_transmural_1d_mesh(self, kw):
        from fib_tf_tpu.models import TenTusscher06
        from fib_tf_tpu.parallel import make_mesh, shard_state
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        cfg = SimConfig(width=32, height=64, dt=0.02, duration=1,
                        cell_type="transmural")
        m = TenTusscher06(cfg)
        geom = grid_geometry()
        want = {k: jnp.asarray(v)
                for k, v in m.initial_state(s1=True).items()}
        step = jax.jit(lambda s: m.step(s, geom))
        for _ in range(3):
            want = step(want)
        mesh = make_mesh((4,), devices=jax.devices()[:4])
        chunk = make_spmd_chunk(m, mesh, length=3, **kw)
        got, _ = chunk(shard_state(m.initial_state(s1=True), mesh))
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]),
                rtol=1e-4, atol=1e-5, err_msg=f"{kw} {k}",
            )

    def test_depth_banded_volume_all_paths(self):
        """transmural_volume_state (z-banded wedge): XLA == GSPMD
        z-sharded == wide-halo shard_map, het planes preserved, per
        -slice s rest blended."""
        from fib_tf_tpu.engine.volume import run_volume
        from fib_tf_tpu.models import TenTusscher06
        from fib_tf_tpu.models.tp06 import transmural_volume_state
        from fib_tf_tpu.parallel import make_mesh

        cfg = SimConfig(width=32, height=16, dt=0.02, duration=1,
                        cell_type="transmural")
        m = TenTusscher06(cfg)
        vs = transmural_volume_state(m, 8)
        assert vs["_p_g_ks"].shape == (8, 16, 32)
        # z-banded at (0.25, 0.60) x 8 slices: endo z<2, M 2-4, epi 5+
        assert vs["_p_endo"][0].all() and not vs["_p_endo"][2].any()
        assert vs["s"][0, 0, 0] != vs["s"][7, 0, 0]
        st1, _, _ = run_volume(m, 8, 5, state=vs)
        assert np.isfinite(np.asarray(st1["V"])).all()
        np.testing.assert_array_equal(np.asarray(st1["_p_g_ks"]),
                                      vs["_p_g_ks"])
        mesh = make_mesh((4,), devices=jax.devices()[:4])
        st2, _, _ = run_volume(m, 8, 5, state=vs, mesh=mesh)
        st3, _, _ = run_volume(m, 8, 5, state=vs, mesh=mesh,
                               wide_halo=True, halo_k=2)
        for k in st1:
            np.testing.assert_allclose(
                np.asarray(st2[k]), np.asarray(st1[k]),
                rtol=1e-5, atol=1e-6, err_msg=f"gspmd {k}")
            np.testing.assert_allclose(
                np.asarray(st3[k]), np.asarray(st1[k]),
                rtol=1e-4, atol=1e-5, err_msg=f"wide {k}")

    def test_transmural_requires_het(self):
        from fib_tf_tpu.models import TenTusscher06
        from fib_tf_tpu.models.tp06 import transmural_volume_state

        m = TenTusscher06(SimConfig(width=16, height=16, dt=0.02,
                                    duration=1))
        with pytest.raises(ValueError, match="transmural"):
            transmural_volume_state(m, 4)


@pytest.mark.slow
class TestHetPlanePhysics:
    """The substrate science the planes exist for (measured pins;
    protocol = engine/ensemble events + utils/apd maps, the same
    machinery as examples/tp06_transmural.py)."""

    @staticmethod
    def _paced_map(model, width, height, bcl, beats, mask_cols=None,
                   tail=500.0):
        from fib_tf_tpu.engine.ensemble import (
            EnsembleEvent, run_ensemble, stack_states,
        )
        from fib_tf_tpu.utils.apd import apd_map

        dt_ms = model.dt_per_step * model.cfg.dt
        mask = np.full((height, width), model.min_v, np.float32)
        if mask_cols is None:
            mask[:] = 20.0                      # uniform field stim
        else:
            mask[:, :mask_cols] = 0.0           # edge pacing
        steps = [int(round(10 / dt_ms)) + k * int(round(bcl / dt_ms))
                 for k in range(beats)]
        n = steps[-1] + int(round(tail / dt_ms))
        ev = [EnsembleEvent(step=int(s), mask=mask) for s in steps]
        _, mv = run_ensemble(
            model, stack_states([model.initial_state(s1=False)]), n,
            events=ev, probe=lambda s: s[model.pot_key])
        return apd_map(np.asarray(mv)[0], frame_ms=dt_ms)

    def test_transmural_apd_dispersion(self):
        """4x128 wedge, 2 beats at BCL 800 from the endo edge.
        Measured: band-center APD90 endo 303.0 / M 363.2 / epi 304.0
        ms, transmural dispersion 70.1 ms — the M dome survives
        electrotonic coupling (0D Δ is ~108 ms, tests/test_tp06.py)."""
        from fib_tf_tpu.models import TenTusscher06

        w = 128
        cfg = SimConfig(width=w, height=4, dt=0.02, diff=0.809,
                        duration=10, cell_type="transmural")
        r = self._paced_map(TenTusscher06(cfg), w, 4, bcl=800.0,
                            beats=2, mask_cols=4)
        assert r.valid.all()
        assert r.truncated_fraction == 0.0
        prof = np.nanmean(r.apd_last, axis=0)
        b0, b1 = int(0.25 * w), int(0.60 * w)

        def cmean(lo, hi):
            q = (hi - lo) // 4
            return float(np.nanmean(prof[lo + q:hi - q]))

        endo, mid, epi = cmean(0, b0), cmean(b0, b1), cmean(b1, w)
        assert mid == pytest.approx(363.2, abs=10.0)
        assert endo == pytest.approx(303.0, abs=10.0)
        assert epi == pytest.approx(304.0, abs=10.0)
        assert mid > epi + 40.0
        assert endo == pytest.approx(epi, abs=10.0)
        disp = float(np.nanmax(prof) - np.nanmin(prof))
        assert disp == pytest.approx(70.1, abs=12.0)

    def test_court_regional_remodeling_shortens_apd(self):
        """Isolated cells (diff=0), chronic plane 0 left / 1 right,
        uniform field pacing: the remodeled half repolarizes much
        earlier (measured healthy 282.2 / remodeled 208.6 ms APD90 —
        the i_to/i_Kur/i_CaL downregulation of chronic AF)."""
        from fib_tf_tpu.models import Courtemanche

        m = Courtemanche(SimConfig(width=8, height=4, dt=0.1, diff=0.0,
                                   duration=10))
        plane = np.zeros((4, 8), np.float32)
        plane[:, 4:] = 1.0
        m.set_het(chronic=plane)
        r = self._paced_map(m, 8, 4, bcl=700.0, beats=2)
        assert r.valid.all()
        healthy = float(np.nanmean(r.apd_last[:, :4]))
        remodeled = float(np.nanmean(r.apd_last[:, 4:]))
        assert healthy == pytest.approx(282.2, abs=8.0)
        assert remodeled == pytest.approx(208.6, abs=8.0)
        assert healthy - remodeled > 50.0
        # each half is internally uniform (diff=0: no coupling)
        assert float(np.nanstd(r.apd_last[:, :4])) < 1.0
        assert float(np.nanstd(r.apd_last[:, 4:])) < 1.0


@pytest.mark.slow
class TestPhysics:
    def test_cv_scales_as_sqrt_d(self):
        """Plane wave down a strip whose right half has d = 0.25: the
        wavefront there must travel at ~sqrt(0.25) = 0.5x the speed of
        the d = 1 left half (uniform-d regions conduct exactly like
        scaled diff — TestOperator.test_uniform_dmap_scales_like_diff —
        and CV ~ sqrt(D) for excitable media)."""
        h, w = 16, 256
        cfg = SimConfig(width=w, height=h, dt=0.1, diff=1.5,
                        duration=600.0, dt_per_plot=10)
        model = Fenton4v(cfg)
        d = np.ones((h, w), np.float32)
        d[:, w // 2:] = 0.25
        geom = grid_geometry(dmap=d)
        state = {k: jnp.asarray(v)
                 for k, v in model.initial_state(s1=True).items()}

        @jax.jit
        def outer(s):
            return model.step(s, geom)

        # arrival time (in outer steps) of u >= 0.5 at probe columns
        probes = [40, 88, 168, 216]  # two per half, 48 columns apart
        arrive = {c: None for c in probes}
        for t in range(cfg.samples(model.dt_per_step)):
            state = outer(state)
            u = np.asarray(state["u"][h // 2, :])
            for c in probes:
                if arrive[c] is None and u[c] >= 0.5:
                    arrive[c] = t
            if all(v is not None for v in arrive.values()):
                break
        assert all(v is not None for v in arrive.values()), arrive
        cv_fast = 48.0 / (arrive[88] - arrive[40])
        cv_slow = 48.0 / (arrive[216] - arrive[168])
        ratio = cv_slow / cv_fast
        assert 0.42 < ratio < 0.58, (arrive, ratio)


@pytest.mark.slow
class TestShardedDmap:
    """sharded == unsharded with a heterogeneous diffusion map, on every
    mesh path (narrow, wide-halo, 2D), with
    the ECG probe's heterogeneous source term included."""

    def _reference(self, model, d, length, ecg=None):
        geom = grid_geometry(dmap=d)
        state = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        for _ in range(length):
            state = jax.jit(lambda s: model.step(s, geom))(state)
        return state

    @pytest.mark.parametrize("kw", [
        dict(),                                  # narrow per-substep halos
        dict(wide_halo=True),                    # K-row exchange
    ])
    def test_1d_mesh(self, kw):
        from fib_tf_tpu.parallel import make_mesh, shard_state
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        cfg = SimConfig(width=32, height=64, dt=0.1, diff=1.5, duration=1)
        model = Fenton4v(cfg)
        d = smooth_dmap(64, 32)
        mesh = make_mesh((4,), devices=jax.devices()[:4])
        chunk = make_spmd_chunk(model, mesh, length=3, dmap=d, **kw)
        got, _ = chunk(shard_state(model.initial_state(), mesh))
        want = self._reference(model, d, 3)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]),
                rtol=1e-4, atol=1e-5, err_msg=k,
            )

    def test_2d_mesh_with_phase_and_ecg(self):
        from fib_tf_tpu.parallel import make_mesh, shard_state
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        h = w = 64
        cfg = SimConfig(width=w, height=h, dt=0.1, diff=1.5, duration=1)
        model = Fenton4v(cfg)
        d = smooth_dmap(h, w)
        phase = stencil.add_hole_to_phase_field(None, h, w, 20, 40, 6)
        ecg_w = [stencil.ecg_weights(h, w, 32, 32, 8.0)]
        mesh = make_mesh((2, 2), devices=jax.devices()[:4])
        chunk = make_spmd_chunk(model, mesh, length=3, phase=phase,
                                dmap=d, wide_halo=True,
                                ecg_weights=ecg_w)
        got, probes = chunk(shard_state(model.initial_state(), mesh))

        geom = grid_geometry(phase, dmap=d)
        state = {k: jnp.asarray(v) for k, v in model.initial_state().items()}
        want_ecg = []
        for _ in range(3):
            state = jax.jit(lambda s: model.step(s, geom))(state)
            lap = geom.laplace(geom.enforce_boundary(state["u"]))
            want_ecg.append(float(jnp.sum(lap * jnp.asarray(ecg_w[0]))))
        for k in state:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(state[k]),
                rtol=1e-4, atol=1e-5, err_msg=k,
            )
        np.testing.assert_allclose(np.asarray(probes["ecg"][:, 0]),
                                   want_ecg, rtol=1e-3, atol=1e-4)

    def test_gspmd_matches_unsharded(self):
        from fib_tf_tpu.parallel import make_mesh, plane_sharding

        cfg = SimConfig(width=32, height=64, dt=0.1, diff=1.5, duration=1)
        model = Fenton4v(cfg)
        d = smooth_dmap(64, 32)
        geom = grid_geometry(dmap=d)
        mesh = make_mesh((8,))
        sh = plane_sharding(mesh)
        state = {k: jax.device_put(jnp.asarray(v), sh)
                 for k, v in model.initial_state().items()}
        step = jax.jit(lambda s: model.step(s, geom))
        got = step(step(step(state)))
        want = self._reference(model, d, 3)
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]),
                rtol=1e-4, atol=1e-5, err_msg=k,
            )

    def test_engine_mesh_auto_with_dmap(self):
        """Config-routed mesh run (mesh_mode auto -> shard_map wide-halo)
        with a fibrosis map == the unsharded engine run."""
        base = dict(width=32, height=64, dt=0.1, diff=0.809, duration=2,
                    dt_per_plot=10, cheby=True, skip=True)
        d = stencil.fibrosis_map(64, 32, density=0.25, strength=0.6,
                                 seed=7, patch=2)
        sim1 = Simulation(BeelerReuter(SimConfig(**base)))
        sim1.set_diffusion_map(d)
        r1 = sim1.define().simulate()
        sim2 = Simulation(BeelerReuter(SimConfig(mesh_shape=(8,), **base)))
        sim2.set_diffusion_map(d)
        r2 = sim2.define().simulate()
        np.testing.assert_allclose(r2.probes["v"], r1.probes["v"],
                                   rtol=1e-4, atol=1e-5)
        for k in r1.state:
            np.testing.assert_allclose(r2.state[k], r1.state[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
