"""Wide-halo shard_map chunk for 3D volumes (z-sharded).

The 3D analog of the 2D engine's wide-halo shard_map path
(parallel/spmd.py) for `engine/volume.run_volume`: the `[D, H, W]` state
is sharded along z, each outer step exchanges K = dt_per_step ghost
SLICES each way via ring ppermute (one big message per neighbor per
outer step instead of one per substep), and the whole fused substep
group runs on the extended block.  Ghost slices decay one ring per
substep, exactly like the 2D wide-halo rows.

The z-coupling is one slice of state each way; in-plane each shard owns
the full sheet, so in-plane operators need no communication and the 2D
extruded phase field is simply replicated.  Per-slice fiber tensors
(rotational anisotropy) are z-sharded and halo-extended once per chunk
— static data is exchanged once (same rule as parallel/spmd.py's
phase handling).

Probes mirror run_volume's: the scalar v probe is a masked psum (only
the shard owning the mid-depth slice contributes), and the per-slice
rotor census is z-elementwise so each shard emits its own slice rows
(out_spec shards the D axis of the census — zero extra collectives).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from fib_tf_tpu.models.base import IonicModel
from fib_tf_tpu.ops.stencil3d import ecg_sample, zblock_geometry


def check_volume_shards(depth: int, n_shards: int, k: int) -> None:
    """Wide-halo precondition: z divides evenly and every shard owns at
    least K slices (ghosts come from the immediate neighbor only)."""
    if depth % n_shards != 0:
        raise ValueError(
            f"depth {depth} not divisible by the mesh's {n_shards} shards"
        )
    if depth // n_shards < k:
        raise ValueError(
            f"wide_halo needs >= K={k} z-slices per shard (K = halo_k or "
            f"dt_per_step), got {depth // n_shards}; use fewer devices, a "
            f"deeper volume, or a smaller halo_k"
        )


def resolve_halo_k(model: IonicModel, halo_k: Optional[int]) -> int:
    """Validate and resolve the wide-halo exchange cadence: `None` means
    one exchange of dt_per_step ghost slices per outer step; an explicit
    `halo_k` splits the outer step into dt_per_step/halo_k groups of
    halo_k substeps, each preceded by a halo_k-slice exchange — smaller
    shards-per-device and smaller fused blocks for more halo messages.
    Requires a model whose substeps are uniform (IonicModel
    .has_uniform_substeps; BR's skip groups and Courtemanche's fast/slow
    split are not splittable at arbitrary boundaries)."""
    if halo_k is None:
        return model.dt_per_step
    if not 1 <= halo_k <= model.dt_per_step:
        raise ValueError(
            f"halo_k must be in [1, dt_per_step={model.dt_per_step}], "
            f"got {halo_k}"
        )
    if model.dt_per_step % halo_k != 0:
        raise ValueError(
            f"halo_k={halo_k} must divide dt_per_step="
            f"{model.dt_per_step}"
        )
    if halo_k != model.dt_per_step and not model.has_uniform_substeps:
        raise ValueError(
            f"halo_k < dt_per_step needs uniform substeps, which "
            f"{model.name} does not have with this config (BR skip "
            f"groups / Courtemanche fast-slow split / adaptive_dv are "
            f"not splittable at arbitrary substep boundaries)"
        )
    return halo_k


def make_volume_spmd_chunk(
    model: IonicModel,
    mesh: Mesh,
    length: int,
    depth: int,
    fire: Sequence[Tuple[int, jnp.ndarray]] = (),
    phase: Optional[np.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
    rotor: bool = False,
    tau_steps: int = 0,
    rotor_v_star: float = 0.5,
    halo_k: Optional[int] = None,
    ecg_weights: Optional[jnp.ndarray] = None,
):
    """Build a jitted `chunk(state, buf, idx) -> (state, buf, idx,
    probes)` advancing `length` outer steps of a z-sharded `[D, H, W]`
    volume entirely inside one shard_map over `mesh`'s first axis —
    drop-in for run_volume's single-device chunk.

    `fire` is the chunk-relative event list [(step, [D, H, W] mask)];
    masks are z-sharded alongside the state.  `fiber` is the tuple of
    `[D]` per-slice tensor arrays (stencil3d.fiber_tensors) or None.
    With `rotor`, `buf` is the [tau, D, H, W] delay ring buffer (sharded
    on D) and probes gain the per-slice census stream.

    `ecg_weights` = [E, D, H, W] lead-field planes (z-sharded with the
    state): each shard evaluates the model's own discrete source term —
    zblock_geometry's laplace (incl. dz_ratio, phase correction, and the
    per-slice fiber tensors) over a ONE-ghost-slice extension of its
    block (enforce_boundary is mask-based and costs no halo validity;
    the operator costs exactly one slice each way) — and the electrode
    potentials are psums of the local einsum partials ('ecg' stream,
    value-identical to run_volume's unsharded path)."""
    axis = mesh.axis_names[0]
    n_shards = int(mesh.devices.shape[0])
    k = resolve_halo_k(model, halo_k)
    n_groups = model.dt_per_step // k
    check_volume_shards(depth, n_shards, k)
    d_local = depth // n_shards
    ext_d = d_local + 2 * k
    pot_key = model.pot_key
    probe_row, probe_col = model.probe_pixel
    zmid = depth // 2
    names = model.state_keys()

    has_phase = phase is not None
    phase_arr = jnp.asarray(np.asarray(phase, np.float32)) if has_phase \
        else None
    has_fiber = fiber is not None
    fiber_arrs = [
        jnp.asarray(np.broadcast_to(np.asarray(c, np.float32), (depth,))
                    .reshape(depth, 1, 1).copy())
        for c in (fiber or ())
    ]
    ev_masks = [jnp.asarray(m) for _, m in fire]
    ev_steps = [int(t) for t, _ in fire]
    has_ecg = ecg_weights is not None

    def extend_k(v, kk):
        n = lax.axis_size(axis)
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [(i, (i - 1) % n) for i in range(n)]
        top = lax.ppermute(v[-kk:], axis, fwd)
        bottom = lax.ppermute(v[:kk], axis, bwd)
        return jnp.concatenate([top, v, bottom], axis=0)

    def extend(v):
        return extend_k(v, k)

    def local_fn(state, buf, idx, *extras):
        i = 0
        phase_local = None
        if has_phase:
            phase_local = extras[i]
            i += 1
        fiber_local = None
        if has_fiber:
            fiber_local = tuple(extras[i:i + 3])
            i += 3
        ew_local = None
        if has_ecg:
            ew_local = extras[i]
            i += 1
        masks_local = extras[i:]

        zstart = lax.axis_index(axis) * d_local - k
        zg = zstart + lax.broadcasted_iota(jnp.int32, (ext_d, 1, 1), 0)
        fiber_ext = (
            tuple(extend(f) for f in fiber_local) if has_fiber else None
        )
        geom = zblock_geometry(zg, depth, phase_local, dz_ratio, fiber_ext)

        ecg_lap = None
        if has_ecg:
            # probe-only source term over a ONE-ghost-slice extension:
            # enforce_boundary is mask-based (costs no halo validity),
            # the operator's z-coupling costs exactly one slice each way
            zg1 = (lax.axis_index(axis) * d_local - 1
                   + lax.broadcasted_iota(
                       jnp.int32, (d_local + 2, 1, 1), 0))
            fiber_e1 = (
                tuple(extend_k(f, 1) for f in fiber_local)
                if has_fiber else None
            )
            geom1 = zblock_geometry(
                zg1, depth, phase_local, dz_ratio, fiber_e1
            )

            def ecg_lap(v):
                return geom1.laplace(
                    geom1.enforce_boundary(extend_k(v, 1))
                )[1:-1]

        def probe_v(s):
            lz = zmid - lax.axis_index(axis) * d_local
            owned = (lz >= 0) & (lz < d_local)
            val = jnp.where(
                owned,
                lax.dynamic_index_in_dim(
                    s[pot_key], jnp.clip(lz, 0, d_local - 1), 0,
                    keepdims=False,
                )[probe_row, probe_col],
                0.0,
            )
            return (lax.psum(val, axis) - model.min_v) / (
                model.max_v - model.min_v
            )

        def advance(s):
            ext = {kk: extend(v) for kk, v in s.items()}
            if n_groups > 1:
                ext = model.substep_group(ext, geom, k)
            else:
                ext = model.step(ext, geom)
            return {kk: v[k:-k] for kk, v in ext.items()}

        def body(carry, _):
            s, i, buf, idx = carry
            for _ in range(n_groups):
                s = advance(s)
            pot = s[pot_key]
            for t, m in zip(ev_steps, masks_local):
                pot = jnp.where(i == t, jnp.maximum(pot, m), pot)
            s = {**s, pot_key: pot}
            out = {"v": probe_v(s)}
            if has_ecg:
                out["ecg"] = lax.psum(
                    ecg_sample(ecg_lap(s[pot_key]), ew_local), axis
                )
            if rotor:
                from fib_tf_tpu.ops import stencil

                img = model.image(s)
                old = lax.dynamic_index_in_dim(buf, idx, 0, keepdims=False)
                out["rotors"] = jax.vmap(
                    lambda a, b: stencil.rotor_metrics(
                        a, b, v_star=rotor_v_star
                    )
                )(img, old)
                buf = lax.dynamic_update_index_in_dim(buf, img, idx, 0)
                idx = (idx + 1) % tau_steps
            return (s, i + 1, buf, idx), out

        (s, _, buf, idx), p = lax.scan(
            body, (state, jnp.int32(0), buf, idx), None, length=length
        )
        return s, buf, idx, p

    zplane = P(axis, None, None)
    state_spec = {kk: zplane for kk in names}
    buf_spec = P(None, axis, None, None) if rotor else P()
    in_specs = [state_spec, buf_spec, P()]
    if has_phase:
        in_specs.append(P(None, None))
    if has_fiber:
        in_specs.extend([zplane] * 3)
    if has_ecg:
        in_specs.append(P(None, axis, None, None))
    in_specs.extend(zplane for _ in ev_masks)
    probes_spec: Dict[str, P] = {"v": P()}
    if has_ecg:
        probes_spec["ecg"] = P()
    if rotor:
        probes_spec["rotors"] = P(None, axis)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(state_spec, buf_spec, P(), probes_spec),
        check_vma=False,
    )

    @jax.jit
    def chunk(state, buf, idx):
        return fn(
            state, buf, idx,
            *([phase_arr] if has_phase else []),
            *fiber_arrs,
            *([jnp.asarray(ecg_weights)] if has_ecg else []),
            *ev_masks,
        )

    return chunk
