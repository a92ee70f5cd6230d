"""3D (volume) simulation — scroll waves, beyond reference parity.

The reference is strictly 2D; its spiral-reentry experiments
(fenton.py:155-187, br.py S2 protocols) have a 3D generalization — the
scroll wave — that this runner makes a one-call experiment.  The design
mirrors `engine/ensemble.py`: a standalone jitted-scan driver (the full
`Simulation` engine's events/observers/viz are sheet-shaped), with the
model zoo reused UNCHANGED — ionic math is elementwise, and the two
spatial operators come from the injected 3D `Geometry`
(models/base.volume_geometry, ops/stencil3d).

Scaling: with a `mesh`, the z axis is sharded — GSPMD (one ghost slice
each way as XLA collectives) or the wide-halo shard_map path
(parallel/volume_spmd.py), with `halo_k` sub-cadence for shallow shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.models.base import IonicModel, volume_geometry
from fib_tf_tpu.ops import stencil3d
from fib_tf_tpu.utils import cache

State = Dict[str, jnp.ndarray]


def volume_state(
    model: IonicModel, depth: int, s1: bool = True
) -> Dict[str, np.ndarray]:
    """Extrude the model's 2D initial state along z: `[D, H, W]` planes.
    The S1 stimulus becomes a full-depth slab, so the first wave is
    planar in 3D exactly as it is in 2D."""
    st = model.initial_state(s1=s1)
    return {
        k: np.repeat(np.asarray(v, np.float32)[None], depth, axis=0)
        for k, v in st.items()
    }


@dataclass
class VolumeEvent:
    """A stimulus fired at the END of outer step `step`: one of the 8
    named 2D pace locations extruded over z-slices `[z0:z1)` (the
    cross-field S2 that turns a planar wave into a scroll), or an
    explicit `[D, H, W]` mask with background model.min_v."""

    step: int
    loc: Optional[str] = None
    v: Optional[float] = None
    mask: Optional[np.ndarray] = None
    z0: int = 0
    z1: Optional[int] = None

    def resolve_mask(self, model: IonicModel, depth: int) -> np.ndarray:
        if (self.loc is None) == (self.mask is None):
            raise ValueError("VolumeEvent needs exactly one of loc/mask")
        if self.mask is not None:
            return np.asarray(self.mask, np.float32)
        v = model.max_v if self.v is None else self.v
        return stencil3d.pace_mask3d(
            depth, model.cfg.height, model.cfg.width, self.loc, v,
            model.min_v, self.z0, self.z1,
        )


def run_volume(
    model: IonicModel,
    depth: int,
    n_outer: int,
    state: Optional[Dict[str, np.ndarray]] = None,
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber_twist: float = 0.0,
    fiber_angle0: float = 0.0,
    fiber_ratio: float = 1.0,
    fiber_elevation: float = 0.0,
    mesh=None,
    events: Sequence[VolumeEvent] = (),
    probe: Optional[Callable] = None,
    frames_every: Optional[int] = None,
    allow_unstable_dt: bool = False,
    rotor_probe: bool = False,
    rotor_tau_ms: float = 10.0,
    rotor_v_star: float = 0.5,
    electrodes: Sequence[tuple] = (),
    wide_halo: bool = False,
    halo_k: Optional[int] = None,
):
    """Advance a `[depth, H, W]` volume `n_outer` outer steps.

    - `state`: stacked `[D, H, W]` planes (default: `volume_state`).
    - `phase`: optional 2D `[H, W]` field extruded along z.
    - `dz_ratio`: transmural conduction fraction (1.0 = isotropic).
    - `fiber_twist` / `fiber_angle0` / `fiber_ratio`: rotational
      anisotropy — the in-plane fiber direction rotates linearly by
      `fiber_twist` radians across the depth around `fiber_angle0`,
      with cross-fiber conduction `fiber_ratio` (< 1) of along-fiber
      (the ventricular transmural fiber rotation of Fenton & Karma
      1998; ~2.1 rad across a human LV wall).  fiber_ratio = 1 is
      isotropic (the twist is then a no-op and skipped).
    - `fiber_elevation`: imbrication angle (radians) tilting the fiber
      axis OUT of the sheet plane — the full 3x3 tensor
      D = ratio*I + (1-ratio) f f^T with
      f = (cos e cos a, cos e sin a, sin e)
      (stencil3d.fiber_tensors3d / _laplace3d_full; the separable
      in-plane-tensor + dz_ratio model cannot represent the dxz/dyz
      coupling).  Needs fiber_ratio < 1 and leaves dz_ratio at 1.0
      (dzz comes from the tensor; at e = 0 it equals fiber_ratio).
      Runs unsharded and on the GSPMD mesh path (wide_halo implements
      the separable form only).
    - `mesh`: shard the z axis over the mesh's first axis (GSPMD; the
      halo is one z-slice each way).
    - `wide_halo` (needs `mesh`): switch from GSPMD to the explicit
      shard_map schedule (parallel/volume_spmd.py) — K = dt_per_step
      ghost z-slices are exchanged ONCE per outer step (vs one slice per
      substep), and the fused substep group runs on the extended block —
      the 3D analog of the 2D engine's wide-halo path.  Needs depth
      divisible by the mesh size and >= K slices per shard; the default
      probe only (custom `probe` callables see global state, which a
      shard_map body does not have).
    - `halo_k` (wide_halo only): exchange cadence.  Default one
      K = dt_per_step exchange per outer step; an explicit halo_k < K
      exchanges halo_k ghost slices dt_per_step/halo_k times per outer
      step instead — shards need only halo_k slices each (e.g. fenton's
      K = 10 needs depth >= 10 x n_shards, but halo_k=2 runs depth 16
      on 8 devices) and the fused blocks shrink, for more but smaller
      messages (same total bytes).  Needs uniform substeps (fenton, ms,
      BR without skip — not BR skip / Courtemanche).
    - `events`: VolumeEvents fired inside the scan.
    - `probe`: state -> scalar sampled every outer step; default = the
      model's normalized potential at the mid-depth probe pixel (the 3D
      analog of the engine's probe stream).
    - `frames_every`: record the normalized `[D, H, W]` potential every
      this many outer steps (host-side chunking, like the engine's
      dt_per_plot frames).
    - `electrodes`: virtual unipolar electrode positions `(z, y, x)` in
      cell units (floats; typically OFF the tissue, e.g. z = -5 above
      the epicardial face).  Each outer step samples the pseudo-ECG
      Φ(e) ∝ ∫ (1/r) ∇·(D∇V) dv on-device — the discrete source term
      is the SAME `geom.laplace` (incl. anisotropy and phase-field
      correction) the model integrates, weighted by the 1/r lead field
      (stencil3d.ecg_weights).  This is the 3D generalization of the
      reference's 2D Gaussian-mask electrogram (egm.py:5-12): a true
      far-field potential rather than a local masked mean.  With
      electrodes, `probes` is a dict with an `'ecg'` stream of shape
      `[n_outer, n_electrodes]`.  Works on every path: unsharded, GSPMD
      mesh, and the z-sharded `wide_halo` shard_map path (each shard evaluates the
      source term over a one-ghost-slice extension and the electrode
      sums are psums of local partials — r4, parity with the 2D engine's
      sharded ECG).
    - `rotor_probe`: also emit a LIVE per-slice rotor census from inside
      the compiled scan — `[n_outer, D, 2]` of (count, net topological
      charge) per z-slice vs the sample `rotor_tau_ms` ago (the same
      delay-embedding ring buffer as the 2D engine's
      SimConfig.rotor_probe, stencil.rotor_metrics applied slice-wise).
      Unlike the 2D engine's census this one SHARDS with the volume:
      the per-slice winding is z-elementwise, so a z-sharded mesh needs
      no extra collectives.  With `rotor_probe`, `probes` is a dict
      {'v': [n_outer], 'rotors': [n_outer, D, 2]}.

    Returns (final state, probes, frames `[n_frames, D, H, W]` or
    None).  `probes` is the `[n_outer]` potential stream, or — with
    `rotor_probe` and/or `electrodes` — a dict of streams
    {'v': [n_outer], 'rotors': [n_outer, D, 2], 'ecg': [n_outer, E]}.

    Stability: the symbol of the 3D operator bottoms out at
    −(8 + 8·dz_ratio) (in-plane 9-point: −8 at the checkerboard mode,
    ionic.py:49-53 normalization; z term: −8·dz_ratio), so explicit
    Euler needs dt ≤ 2 / ((8 + 8·dz_ratio)·diff) — TIGHTER than 2D's
    2/(8·diff): the reference's canonical dt=0.1 at diff=1.5 is fine on
    a sheet (limit 0.167) but unstable in an isotropic volume (limit
    0.083).  Violations raise up front unless `adaptive_dv` is set (the
    step-doubling integrator re-takes the unstable substeps) or
    `allow_unstable_dt=True` (e.g. a z-uniform volume never excites the
    z modes).
    """
    cache.enable()
    if depth < 3:
        raise ValueError(
            "run_volume needs depth >= 3 (the SYMMETRIC face rewrite "
            "replaces both boundary slices with interior neighbors, so "
            "a 1- or 2-slice volume has no interior); use the 2D engine "
            "for sheets"
        )
    if not 0.0 < fiber_ratio <= 1.0:
        raise ValueError("fiber_ratio must be in (0, 1]")
    full_fiber = fiber_elevation != 0.0
    if full_fiber:
        if fiber_ratio == 1.0:
            raise ValueError(
                "fiber_elevation needs fiber_ratio < 1 (an isotropic "
                "tensor has no fiber axis to tilt)"
            )
        if dz_ratio != 1.0:
            raise ValueError(
                "fiber_elevation builds a full 3x3 tensor with its own "
                "dzz (= fiber_ratio at zero tilt); leave dz_ratio at 1.0"
            )
        if wide_halo:
            raise ValueError(
                "full 3x3 fiber tensors (fiber_elevation) are not "
                "supported with wide_halo (its comm schedule carries "
                "the separable 3-component tensor); use the GSPMD "
                "mesh path"
            )
    fiber = None
    if fiber_ratio < 1.0:
        angles = stencil3d.twist_angles(depth, fiber_angle0, fiber_twist)
        if full_fiber:
            fiber = stencil3d.fiber_tensors3d(angles, fiber_ratio,
                                              fiber_elevation)
        else:
            fiber = stencil3d.fiber_tensors(angles, fiber_ratio)
    if full_fiber:
        # worst-case symbol of the full-tensor operator: 8 per unit of
        # trace (2x-scaled second differences at Nyquist) + 4 per unit
        # of |off-diagonal| (the 4-corner mixed stencils)
        dxx, dxy, dyy, dxz, dyz, dzz = (np.asarray(c) for c in fiber)
        lam = float(np.max(
            8.0 * (dxx + dyy + dzz)
            + 4.0 * (np.abs(dxy) + np.abs(dxz) + np.abs(dyz))
        )) * model.cfg.diff
        limit_doc = "the full-tensor symbol bound"
    else:
        lam = (8.0 + 8.0 * dz_ratio) * model.cfg.diff
        limit_doc = "2/((8 + 8*dz_ratio)*diff)"
    dt_limit = 2.0 / lam
    if (model.cfg.dt > dt_limit and model.cfg.adaptive_dv is None
            and not allow_unstable_dt):
        raise ValueError(
            f"dt={model.cfg.dt} exceeds the 3D explicit stability limit "
            f"{limit_doc} = {dt_limit:.4f}; lower dt or "
            f"dz_ratio, set adaptive_dv (step-doubling rescue), or pass "
            f"allow_unstable_dt=True (e.g. for z-uniform fields)"
        )
    if state is None:
        state = volume_state(model, depth)
    geom = volume_geometry(phase, dz_ratio=dz_ratio, fiber=fiber)
    if wide_halo:
        if mesh is None:
            raise ValueError("wide_halo needs a mesh (z-sharded volume)")
        if model.cfg.adaptive_dv is not None:
            raise ValueError(
                "adaptive_dv is single-chip/GSPMD only; drop "
                "wide_halo or adaptive_dv"
            )
        if probe is not None:
            raise ValueError(
                "custom probe callables are not supported with "
                "wide_halo (the shard_map body sees z-local blocks); "
                "use the default probe or the GSPMD path"
            )
        from fib_tf_tpu.parallel.volume_spmd import (
            check_volume_shards, resolve_halo_k,
        )

        check_volume_shards(depth, int(mesh.devices.shape[0]),
                            resolve_halo_k(model, halo_k))
    h_true, w_true = model.cfg.height, model.cfg.width
    pot_key = model.pot_key

    if probe is None:
        r, c = model.probe_pixel
        r, c = min(r, h_true - 1), min(c, w_true - 1)  # tiny grids

        def probe(s):
            return (
                s[pot_key][depth // 2, r, c] - model.min_v
            ) / (model.max_v - model.min_v)

    ev_masks = [jnp.asarray(e.resolve_mask(model, depth)) for e in events]
    ev_steps = [int(e.step) for e in events]

    ew = None
    if electrodes:
        # [E, D, H, W] lead-field weights
        ew = jnp.asarray(np.stack([
            stencil3d.ecg_weights(depth, h_true, w_true, pos)
            for pos in electrodes
        ]))

    tau_steps = 0
    if rotor_probe:
        tau_steps = max(1, int(round(
            rotor_tau_ms / (model.dt_per_step * model.cfg.dt)
        )))

    _cache: Dict[tuple, Callable] = {}

    def chunk_fn(length: int, start: int):
        fire = [
            (t - start, m)
            for t, m in zip(ev_steps, ev_masks)
            if start <= t < start + length
        ]
        key = (length, tuple((t, id(m)) for t, m in fire))
        if key in _cache:
            return _cache[key]

        if wide_halo:
            from fib_tf_tpu.parallel.volume_spmd import (
                make_volume_spmd_chunk,
            )

            chunk = make_volume_spmd_chunk(
                model, mesh, length, depth, fire=fire, phase=phase,
                dz_ratio=dz_ratio, fiber=fiber,
                rotor=rotor_probe, tau_steps=tau_steps,
                rotor_v_star=rotor_v_star, halo_k=halo_k,
                ecg_weights=ew,
            )
            _cache[key] = chunk
            return chunk

        def body(carry, _):
            s, i, buf, idx = carry
            s = model.step(s, geom)
            pot = s[pot_key]
            for t, m in fire:
                pot = jnp.where(i == t, jnp.maximum(pot, m), pot)
            s = {**s, pot_key: pot}
            out = {"v": probe(s)}
            if ew is not None:
                # the same discrete source term the model integrates:
                # laplace of the boundary-enforced potential (e.g.
                # fenton.py step: diff * laplace(enforce_boundary(u)))
                lap = geom.laplace(geom.enforce_boundary(pot))
                out["ecg"] = stencil3d.ecg_sample(lap, ew)
            if rotor_probe:
                from fib_tf_tpu.ops import stencil

                img = model.image(s)
                old = jax.lax.dynamic_index_in_dim(
                    buf, idx, 0, keepdims=False
                )
                out["rotors"] = jax.vmap(
                    lambda a, b: stencil.rotor_metrics(
                        a, b, v_star=rotor_v_star
                    )
                )(img, old)
                buf = jax.lax.dynamic_update_index_in_dim(buf, img, idx, 0)
                idx = (idx + 1) % tau_steps
            return (s, i + 1, buf, idx), out

        @jax.jit
        def chunk(s, buf, idx):
            (s, _, buf, idx), p = jax.lax.scan(
                body, (s, jnp.int32(0), buf, idx), None, length=length
            )
            return s, buf, idx, p

        _cache[key] = chunk
        return chunk

    st = {k: jnp.asarray(v) for k, v in state.items()}
    if rotor_probe:
        img0 = jnp.asarray(np.asarray(
            model.image({pot_key: np.asarray(state[pot_key], np.float32)}),
            np.float32,
        ))
        buf = jnp.tile(img0[None], (tau_steps, 1, 1, 1))
    else:
        buf = jnp.zeros((), jnp.float32)  # loop-invariant placeholder
    idx = jnp.int32(0)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = mesh.axis_names[0]
        sh = NamedSharding(mesh, P(ax, None, None))
        st = {k: jax.device_put(v, sh) for k, v in st.items()}
        if ew is not None:
            # lead fields shard along z with the volume; the reduction
            # becomes a GSPMD psum
            ew = jax.device_put(ew, NamedSharding(mesh, P(None, ax)))
        if rotor_probe:
            # the ring buffer shards along z too — the per-slice winding
            # is z-elementwise, so the census needs no collectives
            buf = jax.device_put(buf, NamedSharding(mesh, P(None, ax)))

    frames: Optional[List[np.ndarray]] = None
    probes: List[Dict[str, np.ndarray]] = []
    if frames_every is None:
        st, buf, idx, p = chunk_fn(n_outer, 0)(st, buf, idx)
        probes.append(jax.tree.map(np.asarray, p))
    else:
        frames = []
        done = 0
        while done < n_outer:
            length = min(frames_every, n_outer - done)
            st, buf, idx, p = chunk_fn(length, done)(st, buf, idx)
            probes.append(jax.tree.map(np.asarray, p))
            done += length
            img = np.asarray(model.image({pot_key: np.asarray(st[pot_key])}))
            frames.append(img.astype(np.float32))

    final = {k: np.asarray(v) for k, v in st.items()}
    if not np.isfinite(final[pot_key]).all():
        raise FloatingPointError(
            "non-finite potential in run_volume (the reference's disabled "
            "NaN check, ionic.py:208-212, would have integrated on)"
        )
    streams = {
        k: np.concatenate([p[k] for p in probes]) for k in probes[0]
    }
    return (
        final,
        streams if (rotor_probe or ew is not None) else streams["v"],
        np.stack(frames) if frames is not None else None,
    )
