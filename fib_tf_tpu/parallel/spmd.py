"""shard_map chunk builder: the whole scan runs inside one `shard_map`.

Layout: every [H, W] state plane is row-sharded over a 1D mesh axis; each
substep's stencil triggers two 1-row `ppermute`s (see halo.py); per-step
scalar probes are computed with masked `psum`s so every shard returns the
same replicated value.  The phase field is extended (ghost rows + column
pad) ONCE per chunk, not per substep — static data is exchanged once.

This is the explicit alternative to the GSPMD path (sharding.py), kept for
(a) kernel-level control of the comm schedule and (b) as a cross-check:
tests assert shard_map == GSPMD == single-device.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from fib_tf_tpu.models.base import IonicModel
from fib_tf_tpu.ops.stencil import block_geometry
from fib_tf_tpu.parallel.halo import extend_phase, halo_geometry

# Rotor-census ring-buffer state keys — must match Simulation.ROTOR_BUF /
# ROTOR_IDX (engine/simulation.py seeds these planes; the spmd chunk
# shards the [tau, H, W] ring with the grid and replicates the slot index).
ROTOR_BUF = "_rotor_buf_"
ROTOR_IDX = "_rotor_idx_"

_TWO_PI = 2.0 * np.pi


def probe_at(img_local: jnp.ndarray, row: int, col: int,
             axis_name: str) -> jnp.ndarray:
    """Replicated scalar img[row, col] from row-sharded local blocks via a
    masked psum (the owning shard contributes, others add zero)."""
    h = img_local.shape[0]
    idx = lax.axis_index(axis_name)
    local_row = row - idx * h
    in_range = (local_row >= 0) & (local_row < h)
    val = jnp.where(
        in_range,
        lax.dynamic_index_in_dim(
            img_local, jnp.clip(local_row, 0, h - 1), axis=0, keepdims=False
        )[col],
        0.0,
    )
    return lax.psum(val, axis_name)


def probe_at_2d(img_local: jnp.ndarray, row: int, col: int,
                row_axis: str, col_axis: str) -> jnp.ndarray:
    """Replicated scalar img[row, col] from a [rows, cols]-sharded block:
    only the shard owning both coordinates contributes to the psum."""
    h, w = img_local.shape
    lr = row - lax.axis_index(row_axis) * h
    lc = col - lax.axis_index(col_axis) * w
    owned = (lr >= 0) & (lr < h) & (lc >= 0) & (lc < w)
    val = jnp.where(
        owned,
        img_local[jnp.clip(lr, 0, h - 1), jnp.clip(lc, 0, w - 1)],
        0.0,
    )
    return lax.psum(val, (row_axis, col_axis))


def masked_mean(img_local: jnp.ndarray, mask_local: jnp.ndarray,
                axis_names, denom: float) -> jnp.ndarray:
    """Global mean(img * mask) as a psum of local partial sums — the
    electrogram reduction moved on-device (reference egm.py:45-47 did this
    on the host).  `axis_names` may be one axis or a tuple (2D mesh)."""
    return lax.psum(jnp.sum(img_local * mask_local), axis_names) / denom


def _exchange_rows(x: jnp.ndarray, k: int, axis_name: str) -> jnp.ndarray:
    """[h, w] -> [h+2k, w]: prepend the upper neighbor's last k rows and
    append the lower neighbor's first k rows (ring ppermute; the wrapped
    rows at the global edges are never read — see wide-halo notes)."""
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    top = lax.ppermute(x[-k:], axis_name, fwd)
    bottom = lax.ppermute(x[:k], axis_name, bwd)
    return jnp.concatenate([top, x, bottom], axis=0)


def _exchange_cols(x: jnp.ndarray, k: int, axis_name: str) -> jnp.ndarray:
    """[h, w] -> [h, w+2k]: K ghost columns from each column-axis
    neighbor.  Applied to a row-EXTENDED block, the exchanged columns
    carry the sender's row ghosts — the KxK corner blocks the fused
    substep group needs arrive for free (same two-phase trick as
    halo.extend_2d)."""
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    left = lax.ppermute(x[:, -k:], axis_name, fwd)
    right = lax.ppermute(x[:, :k], axis_name, bwd)
    return jnp.concatenate([left, x, right], axis=1)


def _ghost_bottom(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[h, w] -> [h+1, w]: append the lower neighbor's first row (ring
    ppermute; the last shard's wrapped row is masked by the caller)."""
    n = lax.axis_size(axis_name)
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return jnp.concatenate([x, lax.ppermute(x[:1], axis_name, bwd)], axis=0)


def _ghost_right(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[h, w] -> [h, w+1]: append the right neighbor's first column.
    Applied to a bottom-extended block, the ghost column carries the
    sender's own bottom ghost — the diagonal corner cell each 2x2
    plaquette needs (same two-phase trick as halo.extend_2d)."""
    n = lax.axis_size(axis_name)
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return jnp.concatenate(
        [x, lax.ppermute(x[:, :1], axis_name, bwd)], axis=1
    )


def _plaquette_charge(now_e: jnp.ndarray, old_e: jnp.ndarray,
                      v_star: float) -> jnp.ndarray:
    """Topological charge of every 2x2 plaquette of the (ghost-extended)
    local block — the sharded half of ops.stencil.rotor_metrics: the
    winding of theta = atan2(V_now - v*, V_old - v*) around each
    plaquette, in units of 2 pi."""
    theta = jnp.arctan2(now_e - v_star, old_e - v_star)
    t00 = theta[:-1, :-1]
    t01 = theta[:-1, 1:]
    t11 = theta[1:, 1:]
    t10 = theta[1:, :-1]

    def wrap(x):
        return x - _TWO_PI * jnp.round(x / _TWO_PI)

    circ = (
        wrap(t01 - t00) + wrap(t11 - t01)
        + wrap(t10 - t11) + wrap(t00 - t10)
    )
    return jnp.round(circ / _TWO_PI)


def check_wide_halo_shards(
    h_local: int, w_local: int, k: int, is_2d: bool
) -> None:
    """Shared wide-halo precondition: each shard must own at least K rows
    (and K columns on a 2D mesh), because ghost cells come from the
    immediate neighbor only.  Single source of truth for the engine's
    construction-time check and the shard_map trace-time check."""
    if h_local < k or (is_2d and w_local < k):
        raise ValueError(
            f"wide_halo needs >= dt_per_step={k} rows"
            f"{' and columns' if is_2d else ''} per shard, got "
            f"{h_local}x{w_local}; use fewer devices or a larger grid"
        )


def make_spmd_chunk(
    model: IonicModel,
    mesh: Mesh,
    length: int,
    phase: Optional[np.ndarray] = None,
    dmap: Optional[np.ndarray] = None,
    egm_masks: Optional[list] = None,
    wide_halo: bool = False,
    fiber: Optional[tuple] = None,
    trend_points: Optional[tuple] = None,
    ecg_weights: Optional[list] = None,
    rotor: Optional[tuple] = None,
):
    """Build a jitted chunk(state) -> (state, probes) running `length`
    outer steps entirely inside shard_map over `mesh`'s first axis.

    `wide_halo=True` switches the comm schedule from one 1-row ppermute
    pair per SUBSTEP to one K-row ppermute pair per OUTER STEP
    (K = dt_per_step): each shard extends its block by K ghost rows, runs
    the whole fused substep group on the extension (ghost rows turn to
    garbage one ring per substep), and keeps the still-valid center.
    Fewer, larger halo messages — the stencil analog of ring-attention's
    comm/compute overlap.

    2D meshes (rows x cols) are supported on both paths: halo exchange
    runs in two phases (rows, then columns of the row-extended block,
    which carries the diagonal corners for free — halo.extend_2d /
    _exchange_cols); probes psum over both axes.  2D wide-halo exchanges
    K rows + K columns (with KxK corners) once per outer step.

    `fiber` = (dxx, dxy, dyy) from stencil.fiber_tensor selects the
    anisotropic tensor operator (also requires wide_halo — the
    per-substep halo geometries are isotropic).

    Sharded observables (probe parity with the single-chip path):
      * `trend_points` = ((state_key, row, col), ...) emits the per-pixel
        trend stream as masked psums (reference court.py:107-112; rides
        the probes under 'trend');
      * `ecg_weights` = list of [H, W] lead-field weight planes emits the
        far-field pseudo-ECG: each shard computes sum(lap(V) * w_local)
        with a 1-ring halo Laplacian (the same discrete source term as
        the unsharded stencil.ecg_weights path) and psums the partials
        ('ecg').  With `fiber` the source term is the anisotropic tensor
        operator: the probe extends V by ONE ghost ring and evaluates
        block_geometry's fiber branch (value-identical to
        stencil.anisotropic_laplace), cropping the ring — enforce_boundary
        is mask-based and costs no halo validity, the operator costs
        exactly one ring;
      * `rotor` = (tau_steps, v_star) runs the live rotor census: the
        [tau, H, W] delay ring (state keys ROTOR_BUF / ROTOR_IDX, seeded
        by the engine) shards with the grid; each shard computes the
        phase-singularity charge of its own 2x2 plaquettes (one ghost
        row/column fetches the cross-shard plaquettes) and count/net are
        psums ('rotors').
    """
    if fiber is not None and not wide_halo:
        raise ValueError(
            "fiber anisotropy on the shard_map path requires "
            "wide_halo=True (the per-substep halo geometries implement "
            "the isotropic stencil only)"
        )
    is_2d = len(mesh.axis_names) >= 2 and mesh.devices.shape[1] > 1
    axis = mesh.axis_names[0]
    col_axis = mesh.axis_names[1] if is_2d else None
    cfg = model.cfg
    n_cells = cfg.height * cfg.width
    probe_row, probe_col = model.probe_pixel

    all_axes = (axis, col_axis) if is_2d else axis
    plane = P(axis, col_axis) if is_2d else P(axis)
    state_spec = {k: plane for k in model.state_keys()}
    if rotor is not None:
        tau_steps, v_star = rotor
        # the delay ring shards with the plane; the slot index replicates
        state_spec = {
            **state_spec,
            ROTOR_BUF: P(None, axis, col_axis) if is_2d else P(None, axis),
            ROTOR_IDX: P(),
        }

    has_phase = phase is not None
    phase_arr = jnp.asarray(phase) if has_phase else None
    # per-pixel relative diffusion map (fibrosis): shards with the grid,
    # extended once per chunk exactly like the phase field
    has_dmap = dmap is not None
    dmap_arr = jnp.asarray(dmap) if has_dmap else None
    # the reference probes the phase-masked image (ionic.py:213-216);
    # phase is static so a scalar factor at the probe pixel is identical
    probe_scale = (
        float(np.asarray(phase)[probe_row, probe_col]) if has_phase else 1.0
    )
    masks = [jnp.asarray(m) for m in (egm_masks or [])]
    ecg_w_arrs = [jnp.asarray(w) for w in (ecg_weights or [])]

    def local_fn(state, *extras):
        i = 0
        phase_local = None
        if has_phase:
            phase_local = extras[i]
            i += 1
        dmap_local = None
        if has_dmap:
            dmap_local = extras[i]
            i += 1
        local_masks = extras[i:i + len(masks)]
        local_ecg_w = extras[i + len(masks):]

        buf = state.get(ROTOR_BUF)
        idx = state.get(ROTOR_IDX)
        state = {k: v for k, v in state.items()
                 if k not in (ROTOR_BUF, ROTOR_IDX)}

        ecg_lap = None  # set per-branch below when ECG rides the stream

        if wide_halo:
            k = model.dt_per_step
            h_local = next(iter(state.values())).shape[0]
            w_local = next(iter(state.values())).shape[1]
            check_wide_halo_shards(h_local, w_local, k, is_2d)
            rstart = lax.axis_index(axis) * h_local - k
            rg = rstart + jax.lax.broadcasted_iota(
                jnp.int32, (h_local + 2 * k, 1), 0
            )
            if is_2d:
                cstart = lax.axis_index(col_axis) * w_local - k
                cg = cstart + jax.lax.broadcasted_iota(
                    jnp.int32, (1, w_local + 2 * k), 1
                )

                def extend(v):
                    return _exchange_cols(
                        _exchange_rows(v, k, axis), k, col_axis
                    )

                def crop(v):
                    return v[k:-k, k:-k]
            else:
                cg = None

                def extend(v):
                    return _exchange_rows(v, k, axis)

                def crop(v):
                    return v[k:-k]
            phase_ext = extend(phase_local) if has_phase else None
            dmap_ext_b = extend(dmap_local) if has_dmap else None
            if local_ecg_w and fiber is None and not has_dmap:
                # probe-only 1-ring halo Laplacian (the K-row exchange
                # above feeds the step; the ECG source term needs one
                # extra 1-row/col ring per emission — cheap, per outer
                # step)
                from fib_tf_tpu.parallel.halo import (
                    extend_phase_2d, halo_geometry_2d,
                )

                if is_2d:
                    pe1 = (extend_phase_2d(phase_local, axis, col_axis)
                           if has_phase else None)
                    eg = halo_geometry_2d(axis, col_axis, pe1)
                else:
                    pe1 = (extend_phase(phase_local, axis)
                           if has_phase else None)
                    eg = halo_geometry(axis, pe1)

                def ecg_lap(v, _g=eg):
                    return _g.laplace(_g.enforce_boundary(v))
            elif local_ecg_w:
                # fiber and/or dmap source term: extend V by ONE ghost
                # ring and run block_geometry's operator on the
                # extension (enforce_boundary is mask-based — costs no
                # ring; the operator costs exactly one), then crop.
                # Value-identical to the unsharded stencil source.
                rg1 = (lax.axis_index(axis) * h_local - 1
                       + jax.lax.broadcasted_iota(
                           jnp.int32, (h_local + 2, 1), 0))
                if is_2d:
                    cg1 = (lax.axis_index(col_axis) * w_local - 1
                           + jax.lax.broadcasted_iota(
                               jnp.int32, (1, w_local + 2), 1))

                    def ext1e(v):
                        return _exchange_cols(
                            _exchange_rows(v, 1, axis), 1, col_axis
                        )

                    def crop1(v):
                        return v[1:-1, 1:-1]
                else:
                    cg1 = None

                    def ext1e(v):
                        return _exchange_rows(v, 1, axis)

                    def crop1(v):
                        return v[1:-1]
                geom1 = block_geometry(
                    rg1, cfg.height, cg1,
                    cfg.width if is_2d else None,
                    ext1e(phase_local) if has_phase else None, fiber,
                    dmap_ext=(ext1e(dmap_local) if has_dmap else None),
                )

                def ecg_lap(v):
                    return crop1(
                        geom1.laplace(geom1.enforce_boundary(ext1e(v)))
                    )
            geom = block_geometry(
                rg, cfg.height, cg, cfg.width, phase_ext, fiber,
                dmap_ext=dmap_ext_b,
            )

            def advance(s):
                ext = {kk: extend(v) for kk, v in s.items()}
                ext = model.step(ext, geom)
                return {kk: crop(v) for kk, v in ext.items()}

        elif is_2d:
            from fib_tf_tpu.parallel.halo import (
                extend_phase_2d, halo_geometry_2d,
            )

            phase_ext = (
                extend_phase_2d(phase_local, axis, col_axis)
                if has_phase else None
            )
            dmap_ext1 = (
                extend_phase_2d(dmap_local, axis, col_axis)
                if has_dmap else None
            )
            geom = halo_geometry_2d(axis, col_axis, phase_ext, dmap_ext1)

            def ecg_lap(v, _g=geom):
                return _g.laplace(_g.enforce_boundary(v))

            def advance(s):
                return model.step(s, geom)

        else:
            phase_ext = (
                extend_phase(phase_local, axis) if has_phase else None
            )
            dmap_ext1 = (
                extend_phase(dmap_local, axis) if has_dmap else None
            )
            geom = halo_geometry(axis, phase_ext, dmap_ext1)

            def ecg_lap(v, _g=geom):
                return _g.laplace(_g.enforce_boundary(v))

            def advance(s):
                return model.step(s, geom)

        has_ultra = hasattr(model, "ultra_fields")
        if has_ultra:
            # phase-weighted means as psums of local partial sums; the
            # (static) weight total is reduced once per chunk
            w_ultra = (phase_local if has_phase
                       else jnp.ones((next(iter(state.values())).shape)))
            wsum_ultra = lax.psum(jnp.sum(w_ultra), all_axes)

        def probes_of(s):
            img = model.image(s)
            if is_2d:
                v = probe_at_2d(img, probe_row, probe_col, axis, col_axis)
            else:
                v = probe_at(img, probe_row, probe_col, axis)
            probes = {"v": v * probe_scale}
            if has_ultra:
                probes["ultra"] = jnp.stack([
                    lax.psum(jnp.sum(x * w_ultra), all_axes) / wsum_ultra
                    for x in model.ultra_fields(s)
                ])
            if trend_points:
                if is_2d:
                    vals = [probe_at_2d(s[kk], r, c, axis, col_axis)
                            for kk, r, c in trend_points]
                else:
                    vals = [probe_at(s[kk], r, c, axis)
                            for kk, r, c in trend_points]
                probes["trend"] = jnp.stack(vals)
            if local_masks:
                probes["egm"] = jnp.stack([
                    masked_mean(img, m, all_axes, float(n_cells))
                    for m in local_masks
                ])
            if local_ecg_w:
                lap = ecg_lap(s[model.pot_key])
                probes["ecg"] = jnp.stack([
                    lax.psum(jnp.sum(lap * w), all_axes)
                    for w in local_ecg_w
                ])
            return probes

        if rotor is not None:
            # static per-chunk plaquette masks: each shard owns the
            # plaquettes anchored at its own rows (one ghost row/column
            # fetches the cross-shard ones); the last shard's wrapped
            # ghost is excluded by the global-edge mask, obstacle
            # plaquettes by the phase corners — value-identical to the
            # single-chip ops.stencil.rotor_metrics
            h_loc, w_loc = state[model.pot_key].shape
            pr = (lax.axis_index(axis) * h_loc
                  + lax.broadcasted_iota(jnp.int32, (h_loc, 1), 0))
            valid = pr < cfg.height - 1
            if is_2d:
                pc = (lax.axis_index(col_axis) * w_loc
                      + lax.broadcasted_iota(jnp.int32, (1, w_loc), 1))
                valid = valid & (pc < cfg.width - 1)

            def ext1(x):
                e = _ghost_bottom(x, axis)
                return _ghost_right(e, col_axis) if is_2d else e

            tissue = None
            if has_phase:
                pe = ext1(phase_local)
                tissue = (
                    (pe[:-1, :-1] >= 0.5) & (pe[:-1, 1:] >= 0.5)
                    & (pe[1:, 1:] >= 0.5) & (pe[1:, :-1] >= 0.5)
                )

            def rotor_step(s, rbuf, ridx):
                img = model.image(s)
                old = lax.dynamic_index_in_dim(
                    rbuf, ridx, 0, keepdims=False
                )
                q = _plaquette_charge(ext1(img), ext1(old), v_star)
                q = jnp.where(valid, q, 0.0)
                if tissue is not None:
                    q = jnp.where(tissue, q, 0.0)
                metrics = lax.psum(
                    jnp.stack([jnp.sum(jnp.abs(q)), jnp.sum(q)]), all_axes
                )
                rbuf = lax.dynamic_update_index_in_dim(rbuf, img, ridx, 0)
                return metrics, rbuf, (ridx + 1) % tau_steps

        def body(carry, _):
            s, rbuf, ridx = carry
            s = advance(s)
            p = probes_of(s)
            if rbuf is not None:
                p["rotors"], rbuf, ridx = rotor_step(s, rbuf, ridx)
            return (s, rbuf, ridx), p

        (state, buf, idx), out = lax.scan(
            body, (state, buf, idx), None, length=length
        )
        if buf is not None:
            state = {**state, ROTOR_BUF: buf, ROTOR_IDX: idx}
        return state, out

    in_specs = [state_spec]
    if has_phase:
        in_specs.append(plane)
    if has_dmap:
        in_specs.append(plane)
    in_specs.extend(plane for _ in masks)
    in_specs.extend(plane for _ in ecg_w_arrs)

    probes_spec: Dict[str, P] = {"v": P()}
    if hasattr(model, "ultra_fields"):
        probes_spec["ultra"] = P()
    if trend_points:
        probes_spec["trend"] = P()
    if masks:
        probes_spec["egm"] = P()
    if ecg_w_arrs:
        probes_spec["ecg"] = P()
    if rotor is not None:
        probes_spec["rotors"] = P()

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(state_spec, probes_spec),
        check_vma=False,
    )

    # not donated — same per-iteration copy-insertion cost as the engine
    # chunk (see Simulation._chunk_fn); the sharded state's extra lifetime
    # is per-shard HBM only
    @jax.jit
    def chunk(state):
        return fn(state, *( [phase_arr] if has_phase else [] ),
                  *( [dmap_arr] if has_dmap else [] ), *masks,
                  *ecg_w_arrs)

    return chunk
