"""Model base class and geometry abstraction.

The reference's `IonicModel` (ionic.py:30-307) mixes graph construction,
session management, numerics helpers, and the run loop into one stateful
class.  Here the responsibilities split the JAX way:

  * models are *pure function factories*: `initial_state()` makes a state
    pytree (a dict of `[H, W]` float32 arrays), and `step(state, geom)` is a
    pure function advancing one outer step (`dt_per_step` fused substeps,
    the reference's graph-unrolling trick, fenton.py:133-138) — jittable,
    vmappable, shardable;
  * the run loop, events, and observers live in `engine/`;
  * spatial operators are injected via a tiny `Geometry` record so the same
    model runs in 2D tissue (with phase field), in 0D single-cell mode for
    action-potential tests, or inside a halo-exchanged `shard_map` block.

Subclass contract (mirroring reference ionic.py:254-286): set `name`,
`min_v`, `max_v`, `depol`, `dt_per_step`, `pot_key`, implement
`initial_state` and `solve`; `step` defaults to `dt_per_step` x `solve`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.ops import stencil

State = Dict[str, jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Injected spatial operators.

    `laplace` must implement the 9-point REFLECT stencil (+ phase-field
    correction when a phase field is attached); `enforce_boundary` the
    SYMMETRIC no-flux border rewrite.  0D (single-cell) geometry nulls both.
    """

    laplace: Callable[[jnp.ndarray], jnp.ndarray]
    enforce_boundary: Callable[[jnp.ndarray], jnp.ndarray]


def grid_geometry(
    phase: Optional[np.ndarray] = None,
    fiber_angle: Optional[float] = None,
    fiber_ratio: float = 1.0,
    dmap: Optional[np.ndarray] = None,
) -> Geometry:
    """Standard 2D tissue geometry, optionally with a phase field,
    anisotropic fiber conduction, and/or a per-pixel relative diffusion
    map (fibrosis — stencil.laplace's `dmap_padded`; composes with both
    the phase field and the fiber tensor).

    The padded phase field is precomputed once (it is constant across the
    run; values match the reference's per-step REFLECT pad, ionic.py:76).
    With `fiber_angle` set, the Laplacian becomes the anisotropic tensor
    operator (stencil.anisotropic_laplace), including the tensor form of
    the phase-field no-flux correction when a phase field is present.
    """
    pp = None
    if phase is not None:
        pp = jnp.asarray(
            np.pad(np.asarray(phase, np.float32), 1, mode="reflect")
        )
    dp = None
    if dmap is not None:
        dp = jnp.asarray(
            np.pad(np.asarray(dmap, np.float32), 1, mode="reflect")
        )
    if fiber_angle is not None and fiber_ratio != 1.0:
        dxx, dxy, dyy = stencil.fiber_tensor(fiber_angle, fiber_ratio)
        return Geometry(
            laplace=lambda x: stencil.anisotropic_laplace(
                x, dxx, dxy, dyy, phase_padded=pp, dmap_padded=dp
            ),
            enforce_boundary=stencil.enforce_boundary,
        )
    if pp is None and dp is None:
        return Geometry(
            laplace=stencil.laplace,
            enforce_boundary=stencil.enforce_boundary,
        )
    return Geometry(
        laplace=lambda x: stencil.laplace(x, phase_padded=pp,
                                          dmap_padded=dp),
        enforce_boundary=stencil.enforce_boundary,
    )


def volume_geometry(
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
) -> Geometry:
    """3D `[D, H, W]` tissue geometry (beyond reference parity — the
    reference is strictly 2D): per-slice 9-point stencil + 2x-scaled z
    second difference (ops/stencil3d.laplace3d; planar waves conduct at
    the same speed along z as in-plane) and the SYMMETRIC border rewrite
    on all faces.  `phase` is an optional 2D `[H, W]` field extruded
    along z (columnar obstacles; ∂zϕ = 0 exactly).  `fiber` is an
    optional per-slice (or shared) in-plane diffusion tensor
    (dxx, dxy, dyy) for rotational anisotropy — see
    stencil3d.laplace3d / twist_angles / fiber_tensors.  Models run in
    3D unchanged — their math is elementwise except these two
    operators."""
    from fib_tf_tpu.ops import stencil3d

    pp = None
    if phase is not None:
        pp = jnp.asarray(
            np.pad(np.asarray(phase, np.float32), 1, mode="reflect")
        )
    return Geometry(
        laplace=lambda x: stencil3d.laplace3d(
            x, phase_padded=pp, dz_ratio=dz_ratio, fiber=fiber
        ),
        enforce_boundary=stencil3d.enforce_boundary3d,
    )


def cell_geometry() -> Geometry:
    """0D single-cell geometry: no diffusion, no boundary."""
    return Geometry(
        laplace=lambda x: jnp.zeros_like(x),
        enforce_boundary=lambda x: x,
    )


def repeat_substeps(fn: Callable[[State], State], state: State,
                    n: int, unroll: bool) -> State:
    """`n` identical substeps, either Python-unrolled or under
    `lax.fori_loop`.  Same ops in the same order per iteration, so the
    two forms are value-identical.  The fori form keeps one body in the
    traced program, for scans where trace size matters."""
    if unroll or n == 1:
        for _ in range(n):
            state = fn(state)
        return state
    return jax.lax.fori_loop(0, n, lambda i, s: fn(s), state)


class IonicModel:
    """Base class for the ionic model zoo."""

    name: str = "base"
    min_v: float = 0.0
    max_v: float = 1.0
    depol: float = 0.0
    dt_per_step: int = 1
    pot_key: str = "V"
    # recommended integration dt (ms) — what the CLI uses when --dt is
    # not given.  All reference models run at the reference's 0.1 ms
    # (fenton.py:36, br.py:96, court.py:75); stiffer zoo extensions
    # (Luo-Rudy 1991) override.
    default_dt: float = 0.1

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        # per-pixel parameter planes (set_het); {} = homogeneous tissue
        self.het: Dict[str, np.ndarray] = {}
        # per-channel conductance scale factors (set_scale); {} = drug-free
        self.scales: Dict[str, float] = {}
        if cfg.g_scale:
            self.set_scale(**dict(cfg.g_scale))

    # -- per-pixel parameter heterogeneity ---------------------------------------
    #
    # Heterogeneous-substrate support (epi/endo/M cell-type maps, regional
    # chronic-AF remodeling, arbitrary per-pixel conductance scalings):
    # each plane rides the STATE dict under a reserved "_p_<name>" key —
    # models read it in solve() and pass it through unchanged.  Because
    # they are ordinary state planes, every execution path carries them
    # with zero extra plumbing: the single-device scan, GSPMD and
    # shard_map sharding (sharded with the grid; wide-halo ghost rows
    # arrive by the same ppermute as the dynamic planes and are exactly
    # right because the planes are constant), ensembles, checkpoints, and
    # adaptive-dt.  The recurring cost is one extra plane of memory and
    # halo traffic per plane, next to the 8-22 dynamic planes.  (The per-pixel
    # DIFFUSION map is geometry, not an ionic parameter, and rides the
    # phase-field plumbing instead: models/base.grid_geometry's `dmap`.)

    HET_PREFIX = "_p_"
    # names set_het accepts; subclasses that support heterogeneity
    # override (e.g. TenTusscher06: g_to/g_ks/endo, Courtemanche: chronic)
    HET_PARAMS: tuple = ()

    def set_het(self, **planes):
        """Attach per-pixel parameter planes, e.g.
        `model.set_het(chronic=mask)`.  Values broadcast against the
        grid: pass a full [H, W] float array (None removes a plane).
        Must precede initial_state()/define().  Returns self."""
        het = dict(self.het)
        for name, arr in planes.items():
            if name not in self.HET_PARAMS:
                raise ValueError(
                    f"{type(self).__name__} has no heterogeneous "
                    f"parameter {name!r}; available: {self.HET_PARAMS}"
                )
            if arr is None:
                het.pop(name, None)
                continue
            a = np.asarray(arr, np.float32)
            if a.shape != self.state_shape():
                raise ValueError(
                    f"het plane {name!r} shape {a.shape} != grid "
                    f"{self.state_shape()}"
                )
            if not np.isfinite(a).all():
                raise ValueError(f"het plane {name!r} must be finite")
            het[name] = a
        self.het = het
        return self

    def het_keys(self) -> tuple:
        """State-dict keys of the attached planes."""
        return tuple(self.HET_PREFIX + k for k in sorted(self.het))

    def attach_het(self, state: Dict[str, np.ndarray]):
        """Add the _p_* planes to an initial-state dict (models call this
        at the end of initial_state)."""
        for name, arr in self.het.items():
            state[self.HET_PREFIX + name] = np.asarray(arr, np.float32)
        return state

    def het_param(self, state: State, name: str, default):
        """The per-pixel plane when attached, else the scalar default —
        the single read point models use inside solve()."""
        return state.get(self.HET_PREFIX + name, default)

    def carry_het(self, state: State, out: State) -> State:
        """Pass the constant planes through a solve() output."""
        for k in state:
            if k.startswith(self.HET_PREFIX):
                out[k] = state[k]
        return out

    # -- channel block (drug) interface -----------------------------------------
    #
    # Per-channel maximal-conductance scale factors (SimConfig.g_scale /
    # set_scale): the framework-level pharmacology layer.  Factors are
    # Python floats read at TRACE time, so they fold into the compiled
    # step as constants — no extra operations on any execution path
    # (single device, GSPMD/shard_map meshes, vmapped ensembles), and a
    # factor of exactly 1.0 leaves the program bitwise
    # unchanged (gscale returns the unscaled expression untouched).
    # Composes multiplicatively with per-pixel heterogeneity planes
    # (het_param: substrate x dose) and court's chronic remodeling.
    # Beyond reference parity: the reference's only pharmacology was the
    # hard-coded global chronic-AF flag (court.py:193-194, 218).

    # channel names set_scale accepts; subclasses override (e.g. tp06's
    # CiPA panel g_Na/g_CaL/g_Kr/g_Ks/g_to/g_K1/...)
    SCALE_PARAMS: tuple = ()

    def set_scale(self, **factors):
        """Attach per-channel conductance scale factors, e.g.
        `model.set_scale(g_Kr=0.5)` for 50% IKr block.  Factors are
        finite floats >= 0 (1.0 = no block, 0.0 = full block; > 1.0 =
        agonist/up-regulation).  None removes a factor.  Returns self."""
        scales = dict(self.scales)
        for name, f in factors.items():
            if name not in self.SCALE_PARAMS:
                raise ValueError(
                    f"{type(self).__name__} has no scalable channel "
                    f"{name!r}; available: {self.SCALE_PARAMS}"
                )
            if f is None:
                scales.pop(name, None)
                continue
            f = float(f)
            if not np.isfinite(f) or f < 0.0:
                raise ValueError(
                    f"g_scale[{name!r}] must be a finite factor >= 0 "
                    f"(got {f})"
                )
            scales[name] = f
        self.scales = scales
        return self

    def gscale(self, name: str, expr):
        """Scale a conductance (Python float) or a whole current term
        (array) by the attached factor — the single read point models
        use inside solve()/currents().  With no factor (or exactly 1.0)
        the expression is returned untouched, keeping the default path
        bitwise identical and op-free."""
        f = self.scales.get(name, 1.0)
        return expr if f == 1.0 else f * expr

    # -- state -----------------------------------------------------------------

    def state_shape(self):
        return (self.cfg.height, self.cfg.width)

    def _full(self, value: float) -> np.ndarray:
        return np.full(self.state_shape(), value, dtype=np.float32)

    def initial_state(self, s1: bool = True) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def state_keys(self):
        """Sorted state-plane names, for metadata-only callers (sharding
        specs, engine sizing).  Default derives them
        from initial_state; models whose initial_state does real work
        (e.g. the ab2 derivative bootstrap) override this with the
        literal key tuple."""
        return tuple(sorted(self.initial_state(s1=False).keys()))

    # -- dynamics ---------------------------------------------------------------

    def solve(self, state: State, geom: Geometry) -> State:
        """One explicit-Euler substep (dt)."""
        raise NotImplementedError

    def step(self, state: State, geom: Geometry,
             unroll: bool = True) -> State:
        """One outer step = `dt_per_step` fused substeps.

        The fusion corresponds to the reference's graph unrolling
        (fenton.py:133-138, br.py:96-107): under `jit`+`scan` the host is
        only touched once per outer step.  `unroll=False` runs the
        identical substeps under `lax.fori_loop` instead of a Python
        unroll — value-identical, but the traced program holds one body
        (see repeat_substeps).
        """
        if self.cfg.adaptive_dv is not None:
            return repeat_substeps(
                self.adaptive_substep(geom), state, self.dt_per_step,
                unroll,
            )
        return repeat_substeps(
            lambda s: self.solve(s, geom), state, self.dt_per_step, unroll
        )

    # -- adaptive-dt step-doubling (ops/adaptive.py) -----------------------------

    def adaptive_clones(self):
        """`[self, dt/2 clone, dt/4 clone, ...]` down to
        dt / 2**adaptive_depth, cached on the instance.  Clones are built
        through the subclass constructor from the scaled cfg, so every
        dt-baked constant (Chebyshev-folded RL multipliers, multi-rate
        dt_for schedules) is re-derived consistently."""
        clones = getattr(self, "_adaptive_clones", None)
        if clones is None:
            clones = [self] + [
                type(self)(self.cfg.replace(dt=self.cfg.dt / 2 ** k))
                for k in range(1, self.cfg.adaptive_depth + 1)
            ]
            for c in clones[1:]:
                # het planes / channel-block factors attached
                # post-construction (set_het / set_scale) must follow the
                # clones, or refined substeps would silently fall back to
                # the homogeneous/drug-free model; config-derived values
                # (tp06 transmural, cfg.g_scale) are rebuilt identically
                # by the constructor and this overwrite is a no-op
                c.het = dict(self.het)
                c.scales = dict(self.scales)
            self._adaptive_clones = clones
        return clones

    def adaptive_substep(self, geom: Geometry, solve_fn=None,
                         commit_keys=None):
        """One substep with step-doubling refinement (SimConfig.adaptive_dv).
        Subclass steps with non-trivial substep schedules (BR skip groups,
        the Courtemanche fast/slow split) pass their own `solve_fn` /
        `commit_keys`."""
        from fib_tf_tpu.ops.adaptive import make_adaptive_substep

        if solve_fn is None:
            solve_fn = lambda m, s: m.solve(s, geom)
        return make_adaptive_substep(
            self.adaptive_clones(), self.cfg.adaptive_dv, solve_fn,
            commit_keys,
        )

    @property
    def has_uniform_substeps(self) -> bool:
        """True when `step` is exactly `dt_per_step` identical `solve`
        substeps, each applying the stencil once — the precondition for
        splitting an outer step into arbitrary contiguous groups (the
        wide-halo paths' `halo_k` sub-cadence).  Models with custom
        substep schedules (BR skip groups, the Courtemanche fast/slow
        split) override or fail the base check; adaptive_dv substeps can
        consume multiple stencil applications, so they are excluded."""
        return (type(self).step is IonicModel.step
                and self.cfg.adaptive_dv is None)

    def substep_group(self, state: State, geom: Geometry,
                      count: int) -> State:
        """`count` consecutive substeps — only meaningful when
        `has_uniform_substeps` (callers must check)."""
        for _ in range(count):
            state = self.solve(state, geom)
        return state

    # -- tick-indexed fast/slow dispatch (reference ionic.py:277-286) -----------
    #
    # The reference's third multi-rate mechanism: a subclass that defines
    # `fast_slow_ratio` (plus fast_step/slow_step) gets its slow step on
    # every `fast_slow_ratio`-th outer tick and the fast step otherwise.
    # Like the reference (where it was defined but unused by the three
    # models), none of the bundled models sets it; the engine's run()
    # generator honors it for user extensions.
    fast_slow_ratio: Optional[int] = None

    # State planes that must stay strictly positive (ionic concentrations
    # feeding Nernst logs); the adaptive-dt acceptance test rejects any
    # substep attempt that drives one non-positive (ops/adaptive.py).
    positive_states: tuple = ()

    def fast_step(self, state: State, geom: Geometry) -> State:
        """Outer step when tick % fast_slow_ratio != 0 (the _ode_fast_op
        analog).  Override together with fast_slow_ratio."""
        return self.step(state, geom)

    def slow_step(self, state: State, geom: Geometry) -> State:
        """Outer step when tick % fast_slow_ratio == 0 (the _ode_slow_op
        analog)."""
        return self.step(state, geom)

    def step_for_tick(self, state: State, geom: Geometry, tick: int) -> State:
        """Dispatch mirroring reference ionic.py:277-286: models with a
        fused `step` just use it; fast_slow_ratio models split by tick."""
        if self.fast_slow_ratio:
            if tick % self.fast_slow_ratio == 0:
                return self.slow_step(state, geom)
            return self.fast_step(state, geom)
        return self.step(state, geom)

    # -- views ------------------------------------------------------------------

    def pot(self, state: State) -> jnp.ndarray:
        """Transmembrane potential plane (reference ionic.py:270-275)."""
        return state[self.pot_key]

    def image(self, state: State) -> jnp.ndarray:
        """Potential normalized to [0, 1] grayscale (ionic.py:262-268)."""
        return (state[self.pot_key] - self.min_v) / (self.max_v - self.min_v)

    @property
    def probe_pixel(self):
        """(row, col) of the wavefront-observer pixel — the single source
        of truth used by probe(), the engine's phase scaling, and the
        shard_map probe psum (reference ionic.py:216-224)."""
        return (20, self.cfg.width // 2)

    def probe(self, state: State) -> jnp.ndarray:
        """Scalar emitted per outer step from inside the compiled scan:
        the normalized potential at `probe_pixel`.  Indexes BEFORE
        normalizing so no full-plane image is materialized per step
        (value-identical to image(state)[r, c])."""
        r, c = self.probe_pixel
        return (
            state[self.pot_key][r, c] - self.min_v
        ) / (self.max_v - self.min_v)
