"""The simulation driver.

Replaces the reference's `tf.Session` run loop (ionic.py:171-245).  Key
re-design: instead of one `sess.run` per outer step with host round trips,
the step loop is a `jax.lax.scan` inside a single `jax.jit`, cut
into chunks only where the host must intervene: scheduled pacing events
(the `fire_op` analog, ionic.py:165-169), plot frames, and chunked probe
readback.  Per-step scalars (wavefront pixel, trend pixel, electrode means)
are computed on-device inside the scan and shipped once per chunk.

Two APIs:
  * `Simulation.run(...)` — a generator yielding the outer-step index, drop-in
    compatible with reference-style scripts (`for i in sim.run(): ...
    sim.fire_op('s2')`).  One dispatch per outer step; fine for interactive
    use, not for benchmarks.
  * `Simulation.simulate(...)` — the fast scheduled path: pacing events are
    declared up front (`at_ms`), the engine scans whole segments between
    events, and returns the probe streams + final state.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.models.base import Geometry, IonicModel, grid_geometry
from fib_tf_tpu.ops import stencil
from fib_tf_tpu.engine.observers import CycleLengthDetector
from fib_tf_tpu.utils import cache


@dataclasses.dataclass
class SimResult:
    """Output of `Simulation.simulate`."""

    state: Dict[str, np.ndarray]         # final state (host numpy)
    probes: Dict[str, np.ndarray]        # per-outer-step probe streams
    frames: Optional[np.ndarray]         # [n_frames, H, W] if recorded
    elapsed: float                       # wall seconds (excl. compile)
    steps: int                           # outer steps executed
    cell_updates_per_sec: float
    sim_seconds_per_wall_second: float
    cycle_lengths: List[tuple]


class Simulation:
    """Owns a model + geometry + pacing protocol and drives the run."""

    def __init__(self, model: IonicModel, sharding=None, mesh=None,
                 wide_halo: bool = False):
        """`sharding`: a NamedSharding for the GSPMD path (XLA infers the
        halo collectives).  `mesh`: a jax Mesh for the explicit shard_map
        path (ppermute halos, masked-psum probes; parallel/spmd.py), with
        `wide_halo` selecting one K-row exchange per outer step instead of
        per substep.  `sharding` and `mesh` are mutually exclusive."""
        if sharding is not None and mesh is not None:
            raise ValueError("pass either sharding (GSPMD) or mesh "
                             "(shard_map), not both")
        cache.enable()
        self.model = model
        self.cfg: SimConfig = model.cfg
        self.phase: Optional[np.ndarray] = None
        self.dmap: Optional[np.ndarray] = None
        self._pace_masks: Dict[str, np.ndarray] = {}
        self._egm_masks: List[np.ndarray] = []
        self._ecg_weights: List[np.ndarray] = []
        self._defined = False
        self._geom: Optional[Geometry] = None
        self._chunk_cache: Dict[Tuple, Callable] = {}
        if mesh is None and sharding is None and self.cfg.mesh_shape:
            # config-driven sharding (SimConfig.mesh_shape + mesh_mode):
            # 'auto' takes the shard_map wide-halo path (one K-row
            # exchange per outer step) and falls back to GSPMD with a
            # warning naming the disqualifier; 'spmd'/'gspmd' force one
            from fib_tf_tpu.parallel.sharding import make_mesh, plane_sharding

            m = make_mesh(self.cfg.mesh_shape, self.cfg.mesh_axes)
            mode = self.cfg.mesh_mode
            reason = (self._spmd_disqualifier(m) if mode != "gspmd"
                      else None)
            if mode == "spmd" and reason:
                raise ValueError(
                    f"mesh_mode='spmd' cannot run this configuration: "
                    f"{reason}"
                )
            if mode == "gspmd" or reason:
                if reason:
                    import warnings

                    warnings.warn(
                        f"mesh_mode='auto': falling back to the GSPMD "
                        f"path ({reason})",
                        stacklevel=2,
                    )
                sharding = plane_sharding(m)
            else:
                mesh = m
                wide_halo = True
        self._mesh = mesh
        self._wide_halo = wide_halo
        if (mesh is not None and self.cfg.fiber_angle is not None
                and not wide_halo):
            raise ValueError(
                "fiber anisotropy on the shard_map (mesh=...) path "
                "requires wide_halo=True (the per-substep halo "
                "geometries are isotropic); or use the GSPMD path "
                "(sharding=...) / single device"
            )
        if wide_halo and mesh is not None:
            from fib_tf_tpu.parallel.spmd import check_wide_halo_shards

            n_row_shards = int(mesh.devices.shape[0])
            n_col_shards = int(
                mesh.devices.shape[1] if mesh.devices.ndim > 1 else 1
            )
            check_wide_halo_shards(
                self.cfg.height // n_row_shards,
                self.cfg.width // n_col_shards,
                model.dt_per_step,
                n_col_shards > 1,
            )
        if mesh is not None:
            from fib_tf_tpu.parallel.sharding import plane_sharding

            sharding = plane_sharding(mesh)
        self._sharding = sharding  # optional jax.sharding.Sharding for state
        self.cl_observer: Optional[Callable[[int, float], None]] = None
        self.state: Optional[Dict[str, np.ndarray]] = None  # keep_state output
        self._probe_window: Optional[Tuple[int, Dict]] = None
        self._timeline_done = False

    def _spmd_disqualifier(self, mesh) -> Optional[str]:
        """Why this configuration can't take the shard_map wide-halo path
        (None = it can).  Single source of truth for the mesh_mode
        routing above."""
        cfg = self.cfg
        if cfg.adaptive_dv is not None:
            return ("adaptive_dv refines substeps locally, which would "
                    "read stale shard_map halos (GSPMD's global "
                    "acceptance predicate partitions)")
        if self.model.fast_slow_ratio:
            return ("fast_slow_ratio models scan ratio-groups outside "
                    "the spmd chunk")
        n_rows = int(mesh.devices.shape[0])
        n_cols = int(mesh.devices.shape[1]) if mesh.devices.ndim > 1 else 1
        if cfg.height % n_rows or cfg.width % n_cols:
            return (f"grid {cfg.height}x{cfg.width} is not divisible by "
                    f"the {n_rows}x{n_cols} mesh (shard_map needs even "
                    f"shards; GSPMD pads)")
        from fib_tf_tpu.parallel.spmd import check_wide_halo_shards

        try:
            check_wide_halo_shards(
                cfg.height // n_rows, cfg.width // n_cols,
                self.model.dt_per_step, n_cols > 1,
            )
        except ValueError as e:
            return str(e)
        return None

    # -- geometry construction (before define) ----------------------------------

    def add_hole_to_phase_field(self, x, y, radius, neg: bool = False):
        """Add a circular hole/boundary to the phase field
        (reference ionic.py:83-105; must precede `define`)."""
        if self._defined:
            raise AssertionError(
                "add_hole_to_phase_field must be called before define()"
            )
        self.phase = stencil.add_hole_to_phase_field(
            self.phase, self.cfg.height, self.cfg.width, x, y, radius, neg
        )

    def set_diffusion_map(self, dmap):
        """Attach a per-pixel RELATIVE diffusion map (dimensionless;
        1 = the nominal `cfg.diff`, values < 1 slow conduction — patchy
        fibrosis, gray-zone borders; stencil.fibrosis_map builds the
        canonical random-patch substrate).  CV in a uniform-d region
        scales as sqrt(d).  Beyond reference parity: the reference's only
        spatial structure was the binary phase-field hole
        (ionic.py:83-105); this is its continuous generalization, and it
        composes with phase fields AND fiber anisotropy on every path
        (single device, GSPMD, shard_map wide/narrow halos —
        tests/test_hetero.py).  Must precede define()."""
        if self._defined:
            raise AssertionError(
                "set_diffusion_map must be called before define()"
            )
        dmap = np.asarray(dmap, np.float32)
        if dmap.shape != (self.cfg.height, self.cfg.width):
            raise ValueError(
                f"diffusion map shape {dmap.shape} != grid "
                f"{(self.cfg.height, self.cfg.width)}"
            )
        if not np.isfinite(dmap).all() or (dmap < 0).any():
            raise ValueError("diffusion map must be finite and >= 0")
        self.dmap = dmap

    def add_electrode(self, x, y, radius: float = 5.0):
        """Register a Gaussian virtual electrode whose masked mean rides the
        on-device probe stream (reference egm.py:5-12 computed this on the
        host)."""
        self._egm_masks.append(
            stencil.gaussian_mask(self.cfg.height, self.cfg.width, x, y, radius)
        )

    def add_ecg_electrode(self, x, y, z: float = 5.0):
        """Register a far-field pseudo-ECG electrode floating `z` cell
        units above the sheet at (x, y): Φ(e) ∝ ∫ (1/r)·∇·(D∇V) dA,
        sampled on-device every outer step with the model's own discrete
        Laplacian (anisotropy + phase-field correction included) as the
        source term — a true far-field potential where `add_electrode`
        (reference egm.py:5-12 parity) samples a local masked mean.
        Rides the probe stream under `'ecg'` ([n_steps, n_electrodes]).
        Works on every path — single device, GSPMD, and the
        shard_map mesh (each shard psums its local partial sum of lap·w,
        parallel/spmd.py), including fiber anisotropy on the mesh (the
        sharded probe evaluates the tensor operator over a 1-ring ghost
        extension — r4, closing the last mesh observable gap)."""
        self._ecg_weights.append(
            stencil.ecg_weights(self.cfg.height, self.cfg.width, x, y, z)
        )

    # -- definition --------------------------------------------------------------

    def define(self, s1: bool = True, state: Optional[Dict[str, np.ndarray]] = None):
        """Materialize geometry + initial state.  `state` seeds the run from
        a previous model's final state (checkpoint/resume; reference
        court.py:49-57, 623-626)."""
        self._geom = grid_geometry(self.phase, self.cfg.fiber_angle,
                                   self.cfg.fiber_ratio, dmap=self.dmap)
        init = state if state is not None else self.model.initial_state(s1=s1)
        init = {k: np.asarray(v, dtype=np.float32) for k, v in init.items()}
        if state is not None:
            # reconcile a resumed state with this model's plane set
            # across the ab2 flag: drop stale derivative planes (ab2 run
            # resumed into a non-ab2 model), rebuild missing ones
            # (Euler checkpoint resumed into an ab2 model)
            expected = set(self.model.state_keys())
            stale = {k for k in init if k not in expected}
            if stale:
                if not all(k.startswith("_d") for k in stale):
                    raise ValueError(
                        f"resume state has unknown planes {sorted(stale)} "
                        f"for model {self.model.name!r}"
                    )
                init = {k: v for k, v in init.items() if k in expected}
            missing = expected - set(init)
            if missing:
                if (self.cfg.ab2
                        and hasattr(self.model, "bootstrap_ab2")
                        and all(k.startswith("_d") for k in missing)):
                    init = {
                        k: np.asarray(v, np.float32)
                        for k, v in self.model.bootstrap_ab2(init).items()
                    }
                else:
                    raise ValueError(
                        f"resume state is missing planes {sorted(missing)}"
                    )
        self._initial = init
        self._defined = True
        return self

    def add_pace_op(self, name: str, loc: str, v: float):
        """Register a stimulation op (reference ionic.py:125-163; call after
        define)."""
        if not self._defined:
            raise AssertionError("add_pace_op must be called after define()")
        self._pace_masks[name] = stencil.pace_mask(
            self.cfg.height, self.cfg.width, loc, v, self.model.min_v
        )

    def millisecond_to_step(self, t_ms: float) -> int:
        return self.cfg.millisecond_to_step(t_ms, self.model.dt_per_step)

    # -- compiled pieces -----------------------------------------------------------

    def _device_state(self, init=None):
        init = init if init is not None else self._initial
        put = partial(jax.device_put, device=self._sharding) if (
            self._sharding is not None
        ) else jax.device_put
        return {k: put(jnp.asarray(v)) for k, v in init.items()}

    def _probes(self, state) -> Dict[str, jnp.ndarray]:
        # the reference samples the phase-MASKED image at the observer pixel
        # (ionic.py:213-216); phase is static, so scaling the sampled value
        # by phase[pixel] is identical and free
        scale = 1.0
        if self.phase is not None:
            r, c = self.model.probe_pixel
            scale = float(self.phase[r, c])
        p = {"v": self.model.probe(state) * scale}
        if hasattr(self.model, "trend_probe"):
            p["trend"] = self.model.trend_probe(state)
        if hasattr(self.model, "ultra_observables"):
            # court_ultra's phase-weighted means ride the stream so
            # mid-run cl_observer logging sees LIVE values
            # (reference court_ultra.py:465-486 read .eval() every event)
            p["ultra"] = self.model.ultra_observables(state, self.phase)
        if self._egm_masks:
            img = self.model.image(state)
            p["egm"] = jnp.stack(
                [stencil.electrogram_sample(img, jnp.asarray(m))
                 for m in self._egm_masks]
            )
        if self._ecg_weights:
            # the same discrete source term the model integrates (e.g.
            # fenton.py step: diff * laplace(enforce_boundary(u)))
            lap = self._geom.laplace(
                self._geom.enforce_boundary(state[self.model.pot_key])
            )
            p["ecg"] = jnp.stack(
                [jnp.sum(lap * jnp.asarray(w)) for w in self._ecg_weights]
            )
        return p

    # -- live rotor census (SimConfig.rotor_probe) -----------------------------
    # The time-delay-embedding history rides the state dict under these
    # reserved keys; the chunk bodies split them off before the model
    # step (models rebuild their dict from scratch), so it never sees
    # them.
    ROTOR_BUF = "_rotor_buf_"    # [tau, H, W] ring of normalized potential
    ROTOR_IDX = "_rotor_idx_"    # int32 scalar: slot holding V(t - tau)

    def _rotor_tau_steps(self) -> int:
        """Embedding delay in outer steps (>= 1)."""
        return max(1, int(round(
            self.cfg.rotor_tau_ms / (self.model.dt_per_step * self.cfg.dt)
        )))

    def _seed_rotor(self, dev_state: Dict) -> Dict:
        """Attach the delay ring buffer (tiled with the current image, so
        early counts use V(0) as the delayed sample) to a device state.
        On a shard_map mesh the ring shards with the grid
        (parallel/spmd.py computes the census with psums)."""
        if self._sharding is not None and self._mesh is None:
            raise ValueError(
                "rotor_probe is not supported on the GSPMD path (the "
                "delay ring is not partitioned there); use the shard_map "
                "mesh (Simulation(mesh=...) / mesh_mode='spmd') or run "
                "unsharded"
            )
        if self.model.fast_slow_ratio:
            raise ValueError(
                "rotor_probe is not supported for fast_slow_ratio models "
                "(the ratio-group chunk does not carry the delay buffer)"
            )
        img = self.model.image(dev_state)
        tau = self._rotor_tau_steps()
        buf = jnp.tile(img[None], (tau, 1, 1))
        if self._mesh is not None:
            # ring shards with the grid: [tau, H(, W)] over the mesh axes
            from jax.sharding import NamedSharding, PartitionSpec

            buf = jax.device_put(buf, NamedSharding(
                self._mesh, PartitionSpec(None, *self._mesh.axis_names)
            ))
        return {
            **dev_state,
            self.ROTOR_BUF: buf,
            self.ROTOR_IDX: jnp.zeros((), jnp.int32),
        }

    def _split_rotor(self, state: Dict):
        """(model_state, buf, idx) — buf/idx None when not riding."""
        if self.ROTOR_BUF not in state:
            return state, None, None
        core = {k: v for k, v in state.items()
                if k not in (self.ROTOR_BUF, self.ROTOR_IDX)}
        return core, state[self.ROTOR_BUF], state[self.ROTOR_IDX]

    def _rotor_step(self, state: Dict, buf, idx):
        """One ring-buffer turn: emit [count, net] vs the sample tau steps
        ago, overwrite that slot with the current image.  `state` is the
        TRUE-grid (cropped) model state."""
        tau = self._rotor_tau_steps()
        img = self.model.image(state)
        old = jax.lax.dynamic_index_in_dim(buf, idx, 0, keepdims=False)
        phase = (jnp.asarray(self.phase)
                 if self.phase is not None else None)
        metrics = stencil.rotor_metrics(
            img, old, v_star=self.cfg.rotor_v_star, phase=phase
        )
        buf = jax.lax.dynamic_update_index_in_dim(buf, img, idx, 0)
        return metrics, buf, (idx + 1) % tau

    def _fiber(self):
        """(dxx, dxy, dyy) when anisotropic, else None — the shard_map
        path's block geometry implements the tensor operator
        (value-identical to stencil.anisotropic_laplace)."""
        if self.cfg.fiber_angle is not None and self.cfg.fiber_ratio != 1.0:
            return stencil.fiber_tensor(
                self.cfg.fiber_angle, self.cfg.fiber_ratio
            )
        return None

    def _chunk_fn(self, length: int, step=None, variant: str = ""):
        """Jitted scan of `length` outer steps; emits probe streams and a
        finiteness flag.  `step` overrides the outer-step function (used
        by the fast/slow tick dispatch) and MUST come with a unique
        `variant` cache key — two different overrides with the same
        (length, variant) would silently alias."""
        if step is not None and not variant:
            raise ValueError("a step override requires a variant cache key")
        use_spmd = self._mesh is not None and step is None
        key = (length, id(self._geom), variant, use_spmd)
        if key in self._chunk_cache:
            return self._chunk_cache[key]

        if use_spmd:
            chunk = self._spmd_chunk_fn(length)
            self._chunk_cache[key] = chunk
            return chunk

        model, geom = self.model, self._geom
        if step is None:
            step = lambda state: model.step(state, geom)  # noqa: E731

        def body(carry, _):
            state, buf, idx = carry
            state = step(state)
            p = self._probes(state)
            if buf is not None:
                p["rotors"], buf, idx = self._rotor_step(state, buf, idx)
            return (state, buf, idx), p

        # Not donated: the input state stays alive for one chunk, so
        # the state is held twice.  Whether donation pays on the GPU is
        # unmeasured.
        @jax.jit
        def chunk(state):
            state, buf, idx = self._split_rotor(state)
            (state, buf, idx), out = jax.lax.scan(
                body, (state, buf, idx), None, length=length
            )
            # cheap per-chunk failure detection (the reference's NaN check
            # existed but was commented out, ionic.py:208-212)
            finite = jnp.isfinite(state[model.pot_key]).all()
            if buf is not None:
                state = {**state, self.ROTOR_BUF: buf, self.ROTOR_IDX: idx}
            return state, out, finite

        self._chunk_cache[key] = chunk
        return chunk

    def _group_chunk_fn(self, n_groups: int, k: int):
        """Chunk for fast_slow_ratio models (reference ionic.py:277-286;
        VERDICT r2 #6): each scan iteration advances one ratio-group —
        slow_step then (k-1) fast_steps — starting at a tick ≡ 0 (mod
        ratio), with probes emitted per OUTER step.  `k` is the ratio for
        full groups, or the final partial group's length."""
        key = ("ratio-group", n_groups, k, id(self._geom))
        if key in self._chunk_cache:
            return self._chunk_cache[key]
        model, geom = self.model, self._geom

        def group(state, _):
            probes = []
            state = model.step_for_tick(state, geom, 0)
            probes.append(self._probes(state))
            for _ in range(k - 1):
                state = model.step_for_tick(state, geom, 1)
                probes.append(self._probes(state))
            out = jax.tree.map(lambda *xs: jnp.stack(xs), *probes)
            return state, out

        @jax.jit
        def chunk(state):
            state, out = jax.lax.scan(group, state, None, length=n_groups)
            # [n_groups, k, ...] -> [n_groups * k, ...] per-outer-step
            out = jax.tree.map(
                lambda x: x.reshape((x.shape[0] * x.shape[1],)
                                    + x.shape[2:]),
                out,
            )
            finite = jnp.isfinite(state[model.pot_key]).all()
            return state, out, finite

        self._chunk_cache[key] = chunk
        return chunk

    def _spmd_chunk_fn(self, length: int):
        """Chunk via the explicit shard_map halo-exchange path
        (parallel/spmd.py), with the engine's (state, probes, finite)
        interface.  Carries the full probe schedule: 'v' wavefront,
        per-pixel 'trend' (masked psums), electrode means, far-field
        'ecg' partial sums, and the 'rotors' census (the delay ring
        shards with the grid) — sharded == unsharded for all of them
        (tests/test_sharding.py)."""
        from fib_tf_tpu.parallel import spmd
        from fib_tf_tpu.parallel.spmd import make_spmd_chunk

        assert (spmd.ROTOR_BUF, spmd.ROTOR_IDX) == (
            self.ROTOR_BUF, self.ROTOR_IDX
        )
        inner = make_spmd_chunk(
            self.model,
            self._mesh,
            length,
            phase=self.phase,
            dmap=self.dmap,
            egm_masks=self._egm_masks or None,
            wide_halo=self._wide_halo,
            fiber=self._fiber(),
            trend_points=getattr(self.model, "trend_points", None),
            ecg_weights=self._ecg_weights or None,
            rotor=((self._rotor_tau_steps(), self.cfg.rotor_v_star)
                   if self.cfg.rotor_probe else None),
        )
        model = self.model

        @jax.jit
        def finite_of(state):
            return jnp.isfinite(state[model.pot_key]).all()

        def chunk(state):
            state, probes = inner(state)
            return state, probes, finite_of(state)

        return chunk

    def _pace_fn(self):
        if hasattr(self, "_pace_jit"):
            return self._pace_jit
        model = self.model
        refresh_ab2 = self.cfg.ab2 and hasattr(model, "_ab2_rates")

        min_v = model.min_v

        @jax.jit
        def pace(state, mask):
            out = {
                **state,
                model.pot_key: stencil.apply_pace(state[model.pot_key], mask),
            }
            if refresh_ab2:
                # the stimulus changed the potential, so the carried
                # f_{n-1} is stale at the paced pixels; re-bootstrap the
                # derivative planes there from the post-stimulus state
                # and keep the carried (diffusion-inclusive) derivatives
                # everywhere else (ADVICE r2: a grid-wide reset would
                # drop the diffusion component of f_{n-1} at wavefronts)
                paced = mask > min_v
                fresh = model._ab2_rates(out)
                out.update({
                    k: jnp.where(paced, v, out[k]) for k, v in fresh.items()
                })
            return out

        self._pace_jit = pace
        return pace

    def probe_at_step(self, i: int, key: str) -> np.ndarray:
        """Probe value at outer step `i` from the chunk currently being
        consumed — valid inside cl_observer callbacks (both the
        simulate() and run() drivers keep the window current)."""
        if self._probe_window is None:
            raise RuntimeError(
                "probe_at_step is only valid while a run is consuming "
                "probe chunks (e.g. inside a cl_observer callback)"
            )
        start, out = self._probe_window
        n = len(out[key])
        if not 0 <= i - start < n:
            raise IndexError(
                f"step {i} outside the live probe window "
                f"[{start}, {start + n})"
            )
        return np.asarray(out[key][i - start])

    def fire_on(self, state, name: str):
        """Apply a registered pacing op to a device state (fire_op analog)."""
        mask = jnp.asarray(self._pace_masks[name])
        return self._pace_fn()(state, mask)

    def _image_fn(self):
        """Jitted frame extractor: normalized potential, phase-masked like
        the reference display path (ionic.py:213-214)."""
        if hasattr(self, "_image_jit"):
            return self._image_jit
        model = self.model
        phase = jnp.asarray(self.phase) if self.phase is not None else None

        @jax.jit
        def image(state):
            img = model.image(state)
            return img * phase if phase is not None else img

        self._image_jit = image
        return image

    # -- fast scheduled path --------------------------------------------------------

    def simulate(
        self,
        schedule: Sequence[Tuple[float, str]] = (),
        state: Optional[Dict[str, np.ndarray]] = None,
        record_frames_every_ms: Optional[float] = None,
        check_finite: bool = True,
        max_chunk_steps: Optional[int] = None,
        warmup: bool = True,
    ) -> SimResult:
        """Run `cfg.duration` ms with pacing events at scheduled times.

        `schedule` is a list of (ms, op_name); ops fire between outer steps,
        exactly like the reference's `fire_op` between `sess.run`s.
        """
        if not self._defined:
            self.define()
        model, cfg = self.model, self.cfg
        # fast_slow_ratio models (tick-indexed dispatch, reference
        # ionic.py:277-286) scan whole ratio-GROUPS per iteration
        # (slow_step + (ratio-1) fast_steps); event steps and chunk cuts
        # snap to group boundaries so every chunk starts at a tick ≡ 0
        # (mod ratio), exactly like the reference's host loop firing ops
        # between aligned sess.runs (VERDICT r2 #6).
        ratio = model.fast_slow_ratio or 0
        samples = cfg.samples(model.dt_per_step)
        plot_interval = cfg.plot_interval(model.dt_per_step)

        # --- segment boundaries: event times (snapped to outer steps) -----
        # +1 matches the reference run()-loop semantics: the generator
        # steps, yields i, and the caller fires at i == s2_step — i.e.
        # AFTER s2_step + 1 outer steps (ionic.py:171-245 usage); the
        # run()/fire_op path here does the same (ADVICE r1 #3).
        def snap(e: int) -> int:
            if ratio:
                e = int(round(e / ratio)) * ratio
            return min(e, samples)

        events = sorted(
            (snap(self.millisecond_to_step(ms) + 1), name)
            for ms, name in schedule
        )
        bounds = [0] + [e[0] for e in events] + [samples]

        frame_stride = None
        if record_frames_every_ms is not None:
            frame_stride = max(
                1, int(record_frames_every_ms / (model.dt_per_step * cfg.dt))
            )
            if ratio:  # keep frame cuts on group boundaries
                frame_stride = -(-frame_stride // ratio) * ratio

        # split segments into chunks (frames force chunking at frame stride)
        if max_chunk_steps is None:
            max_chunk_steps = frame_stride if frame_stride else max(
                1,
                int((cfg.chunk_ms or cfg.duration)
                    / (model.dt_per_step * cfg.dt)),
            )

        dev_state = self._device_state(state)
        if cfg.rotor_probe:
            dev_state = self._seed_rotor(dev_state)
        detector = CycleLengthDetector(
            cfg.dt, model.dt_per_step, plot_interval, self.cl_observer
        )

        probes_acc: Dict[str, List[np.ndarray]] = {}
        frames: List[np.ndarray] = []
        ev_idx = 0
        step = 0

        if ratio:  # chunks must hold whole ratio-groups
            max_chunk_steps = max(
                ratio, -(-max_chunk_steps // ratio) * ratio
            )

        def cut(seg: int, at_step: int) -> int:
            """Chunk length: capped at max_chunk_steps and cut so chunk
            boundaries land exactly on frame-stride multiples even after
            an oddly-placed event shifts them (ADVICE r1 #2).  For ratio
            models, trimmed to whole groups (the only sub-ratio cut is
            the final tail)."""
            l = min(seg, max_chunk_steps)
            if frame_stride:
                l = min(l, frame_stride - at_step % frame_stride)
            if ratio and l >= ratio:
                l -= l % ratio
            return l

        def get_chunk(l: int):
            if ratio:
                if l % ratio == 0:
                    return self._group_chunk_fn(l // ratio, ratio)
                # the final tail: one partial group (< ratio outer steps),
                # still starting at a tick ≡ 0 (mod ratio)
                return self._group_chunk_fn(1, l)
            return self._chunk_fn(l)

        # compile everything first so elapsed measures steady-state compute.
        # jax.jit is lazy — building the wrapper is not enough; each unique
        # chunk length must be EXECUTED once (on a throwaway state copy)
        # to populate the executable cache.
        lengths = set()
        sim_step = 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = b - a
            while seg > 0:
                l = cut(seg, sim_step)
                lengths.add(l)
                seg -= l
                sim_step += l
        if warmup:
            for l in lengths:
                chunk = get_chunk(l)
                scratch = self._device_state(state)
                if cfg.rotor_probe:
                    scratch = self._seed_rotor(scratch)
                s_out, out, fin = chunk(scratch)
                jax.device_get(out["v"][-1:])
                del s_out
        if events:  # warm the pacing op outside the timed region
            warm = self.fire_on(dict(dev_state), events[0][1])
            del warm
        if frame_stride:
            jax.device_get(self._image_fn()(dict(dev_state)))

        then = time.time()
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = b - a
            while seg > 0:
                l = cut(seg, step)
                chunk = get_chunk(l)
                dev_state, out, finite = chunk(dev_state)
                # single host round trip per chunk
                host_out, finite = jax.device_get((out, finite))
                if check_finite and not bool(finite):
                    raise FloatingPointError(
                        f"non-finite {model.pot_key} detected at outer step "
                        f"{step + l}"
                    )
                for k, v in host_out.items():
                    probes_acc.setdefault(k, []).append(np.asarray(v))
                # expose this chunk's probe window so cl_observer callbacks
                # can read live per-step values (probe_at_step)
                self._probe_window = (step, host_out)
                detector.feed(step, np.asarray(host_out["v"]))
                step += l
                seg -= l
                if frame_stride and step % frame_stride == 0:
                    frames.append(np.asarray(self._image_fn()(dev_state)))
            # fire the event that ends at this boundary
            if ev_idx < len(events) and events[ev_idx][0] == b:
                dev_state = self.fire_on(dev_state, events[ev_idx][1])
                ev_idx += 1

        jax.block_until_ready(dev_state[model.pot_key])
        elapsed = time.time() - then

        total_substeps = step * model.dt_per_step
        cups = cfg.height * cfg.width * total_substeps / max(elapsed, 1e-9)
        sim_s = total_substeps * cfg.dt / 1000.0

        final_state = {
            k: np.asarray(v) for k, v in dev_state.items()
            if k not in (self.ROTOR_BUF, self.ROTOR_IDX)
        }
        self.state = final_state

        if cfg.timeline and not self._timeline_done:
            self._capture_timeline(dev_state)
        if cfg.save_graph:
            self._dump_hlo()
        probes = {k: np.concatenate(v) for k, v in probes_acc.items()}
        return SimResult(
            state=final_state,
            probes=probes,
            frames=np.asarray(frames) if frames else None,
            elapsed=elapsed,
            steps=step,
            cell_updates_per_sec=cups,
            sim_seconds_per_wall_second=sim_s / max(elapsed, 1e-9),
            cycle_lengths=detector.cycle_lengths,
        )

    # -- reference-style generator ---------------------------------------------------

    def run(self, im=None, keep_state: bool = False, block: bool = True):
        """Generator yielding the outer-step index, for reference-style
        scripting (ionic.py:171-245).  `fire_op` may be called between
        yields.  Plot frames go to `im` (any object with `imshow`)."""
        if not self._defined:
            self.define()
        model, cfg = self.model, self.cfg
        samples = cfg.samples(model.dt_per_step)
        plot_interval = cfg.plot_interval(model.dt_per_step)
        if model.fast_slow_ratio:
            # tick-indexed fast/slow dispatch (reference ionic.py:277-286):
            # two compiled variants, selected per outer step.  Routed
            # through step_for_tick so a model overriding the dispatch
            # itself is honored (tick=0 is the slow branch, tick=1 fast —
            # the contract is dispatch by tick % fast_slow_ratio only).
            geom = self._geom
            fast = self._chunk_fn(
                1, step=lambda s: model.step_for_tick(s, geom, 1),
                variant="fast")
            slow = self._chunk_fn(
                1, step=lambda s: model.step_for_tick(s, geom, 0),
                variant="slow")

            def step_fn_of(i):
                return slow if i % model.fast_slow_ratio == 0 else fast
        else:
            base = self._chunk_fn(1)

            def step_fn_of(i):
                return base
        self._dev_state = self._device_state()
        if cfg.rotor_probe:
            self._dev_state = self._seed_rotor(self._dev_state)
        detector = CycleLengthDetector(
            cfg.dt, model.dt_per_step, plot_interval, self.cl_observer
        )

        then = time.time()
        for i in range(samples):
            self._dev_state, out, _finite = step_fn_of(i)(self._dev_state)
            yield i
            if im is not None and i % plot_interval == 0:
                im.imshow(np.asarray(self._image_fn()(self._dev_state)))
                host_out = jax.device_get(out)
                self._probe_window = (i, host_out)
                detector.feed(i, np.asarray(host_out["v"]).reshape(-1))

        if keep_state:
            self.state = {
                k: np.asarray(v) for k, v in self._dev_state.items()
                if k not in (self.ROTOR_BUF, self.ROTOR_IDX)
            }
        print("elapsed: %f sec" % (time.time() - then))
        if block and im is not None and hasattr(im, "wait"):
            im.wait()

    def fire_op(self, name: str):
        """Fire a pacing op inside a `run()` loop (ionic.py:165-169)."""
        self._dev_state = self.fire_on(self._dev_state, name)

    # -- observability -----------------------------------------------------------------

    def _capture_timeline(self, dev_state):
        """Profile one chunk with jax.profiler (the reference wrote a Chrome
        trace of one extra sess.run, ionic.py:231-241)."""
        import os

        self._timeline_done = True
        logdir = self.cfg.timeline_name.replace(".json", "_trace")
        os.makedirs(logdir, exist_ok=True)
        chunk = self._chunk_fn(1)
        with jax.profiler.trace(logdir):
            s, _, _ = chunk(dev_state)
            jax.block_until_ready(s[self.model.pot_key])

    def _dump_hlo(self):
        """Dump compiled HLO (the `save_graph` analog of the TF graph dump,
        ionic.py:190-191)."""
        import os

        os.makedirs("logs", exist_ok=True)
        lowered = jax.jit(
            lambda s: self.model.step(s, self._geom)
        ).lower(self._device_state())
        with open(f"logs/{self.model.name}_step_hlo.txt", "w") as f:
            f.write(lowered.as_text())
