"""Explicit halo-exchange geometry for `shard_map` execution.

GSPMD handles the sharded stencil automatically (see sharding.py); this
module is the hand-scheduled alternative: the [H, W] grid is row-sharded
over a 1D mesh axis, each substep exchanges one ghost row with each
neighbor via `lax.ppermute`, and the global REFLECT/SYMMETRIC
boundary rules (reference ionic.py:44-60, 107-113) are applied only on the
edge shards.  Used by the shard_map chunk path in `parallel/spmd.py`, which
keeps the whole scan inside one `shard_map` so static data (the phase
field) is extended once per chunk instead of per substep.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from fib_tf_tpu.models.base import Geometry
from fib_tf_tpu.ops import stencil


def _neighbor_rows(x: jnp.ndarray, axis_name: str):
    """Fetch the ghost rows: previous shard's last row and next shard's
    first row, via two collective-permutes."""
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # send downward
    bwd = [(i, (i - 1) % n) for i in range(n)]   # send upward
    top = lax.ppermute(x[-1:], axis_name, fwd)    # from my upper neighbor
    bottom = lax.ppermute(x[:1], axis_name, bwd)  # from my lower neighbor
    return top, bottom


def _extend_rows(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[h, w] local block -> [h+2, w] with ghost rows; global edges use the
    REFLECT rule (mirror excluding the edge row), matching jnp.pad
    'reflect' on the unsharded array."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    top, bottom = _neighbor_rows(x, axis_name)
    top = jnp.where(idx == 0, x[1:2], top)
    bottom = jnp.where(idx == n - 1, x[-2:-1], bottom)
    return jnp.concatenate([top, x, bottom], axis=0)


def halo_laplace(
    x: jnp.ndarray,
    axis_name: str,
    phase_ext: Optional[jnp.ndarray] = None,
    dmap_ext: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """9-point Laplacian of a row-sharded block, bitwise-matching
    `ops.stencil.laplace` on the gathered array.

    `phase_ext` / `dmap_ext`, if given, are the phase field / relative
    diffusion map already extended to [h+2, w+2] (ghost rows +
    REFLECT-padded columns) by `extend_phase`.
    """
    ext = _extend_rows(x, axis_name)               # [h+2, w]
    xp = jnp.pad(ext, ((0, 0), (1, 1)), mode="reflect")  # [h+2, w+2]
    l = (
        xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2] + xp[1:-1, 2:]
        + 0.5 * (xp[:-2, :-2] + xp[2:, :-2] + xp[:-2, 2:] + xp[2:, 2:])
        - 6.0 * xp[1:-1, 1:-1]
    )
    if dmap_ext is not None:
        l = dmap_ext[1:-1, 1:-1] * l
        q = (dmap_ext * phase_ext if phase_ext is not None
             else dmap_ext)
        phi_c = (phase_ext[1:-1, 1:-1] if phase_ext is not None else 1.0)
        return l + stencil.conduction_correction(xp, q, phi_c)
    if phase_ext is not None:
        l = l + stencil.phase_field_correction(xp, phase_ext)
    return l


def halo_enforce_boundary(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """SYMMETRIC interior rewrite (reference ionic.py:107-113) on a
    row-sharded block: row replacement happens only on the edge shards;
    column replacement is local everywhere."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    row_ids = jnp.arange(x.shape[0])[:, None]
    # top edge: row 0 <- row 1 (only on shard 0)
    x = jnp.where((idx == 0) & (row_ids == 0), x[1:2], x)
    # bottom edge: row h-1 <- row h-2 (only on the last shard)
    x = jnp.where(
        (idx == n - 1) & (row_ids == x.shape[0] - 1), x[-2:-1], x
    )
    # columns are unsharded: plain local replacement
    x = x.at[:, 0].set(x[:, 1])
    x = x.at[:, -1].set(x[:, -2])
    return x


def extend_phase(phase_local: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Extend the (static) local phase block to [h+2, w+2] once per chunk:
    ghost rows from neighbors + REFLECT column pad, matching the padded ϕ
    of stencil.phase_field_correction."""
    ext = _extend_rows(phase_local, axis_name)
    return jnp.pad(ext, ((0, 0), (1, 1)), mode="reflect")


def halo_geometry(
    axis_name: str, phase_ext: Optional[jnp.ndarray] = None,
    dmap_ext: Optional[jnp.ndarray] = None,
) -> Geometry:
    """A Geometry whose operators run on row-sharded local blocks inside
    `shard_map`, exchanging halos between devices."""
    return Geometry(
        laplace=partial(halo_laplace, axis_name=axis_name,
                        phase_ext=phase_ext, dmap_ext=dmap_ext),
        enforce_boundary=partial(halo_enforce_boundary, axis_name=axis_name),
    )


# ---------------------------------------------------------------------------
# 2D (rows x cols) decomposition
# ---------------------------------------------------------------------------

def _neighbor_cols(x: jnp.ndarray, axis_name: str):
    """Ghost columns from the left/right neighbors along the column mesh
    axis (two collective-permutes of [rows, 1] slices)."""
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    left = lax.ppermute(x[:, -1:], axis_name, fwd)
    right = lax.ppermute(x[:, :1], axis_name, bwd)
    return left, right


def _extend_cols(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[h, w] -> [h, w+2] with ghost columns; global edges REFLECT."""
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    left, right = _neighbor_cols(x, axis_name)
    left = jnp.where(idx == 0, x[:, 1:2], left)
    right = jnp.where(idx == n - 1, x[:, -2:-1], right)
    return jnp.concatenate([left, x, right], axis=1)


def extend_2d(x: jnp.ndarray, row_axis: str, col_axis: str) -> jnp.ndarray:
    """[h, w] local block -> [h+2, w+2] full 1-ring extension over a 2D
    mesh.  Two sequential exchange phases: the column phase operates on
    the row-EXTENDED block, so each ghost column carries its sender's own
    row ghosts — which are exactly the four diagonal corner cells the
    9-point stencil needs.  No separate corner messages."""
    ext = _extend_rows(x, row_axis)          # [h+2, w]
    return _extend_cols(ext, col_axis)       # [h+2, w+2]


def halo_laplace_2d(
    x: jnp.ndarray,
    row_axis: str,
    col_axis: str,
    phase_ext: Optional[jnp.ndarray] = None,
    dmap_ext: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """9-point Laplacian of a [rows, cols]-sharded block, bitwise-matching
    `ops.stencil.laplace` on the gathered array."""
    xp = extend_2d(x, row_axis, col_axis)
    l = (
        xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2] + xp[1:-1, 2:]
        + 0.5 * (xp[:-2, :-2] + xp[2:, :-2] + xp[:-2, 2:] + xp[2:, 2:])
        - 6.0 * xp[1:-1, 1:-1]
    )
    if dmap_ext is not None:
        l = dmap_ext[1:-1, 1:-1] * l
        q = (dmap_ext * phase_ext if phase_ext is not None
             else dmap_ext)
        phi_c = (phase_ext[1:-1, 1:-1] if phase_ext is not None else 1.0)
        return l + stencil.conduction_correction(xp, q, phi_c)
    if phase_ext is not None:
        l = l + stencil.phase_field_correction(xp, phase_ext)
    return l


def halo_enforce_boundary_2d(
    x: jnp.ndarray, row_axis: str, col_axis: str
) -> jnp.ndarray:
    """SYMMETRIC interior rewrite on a 2D-sharded block: row replacement
    only on the global top/bottom shards, column replacement only on the
    global left/right shards.  Needs >= 2 rows and columns per shard."""
    ri = lax.axis_index(row_axis)
    rn = lax.axis_size(row_axis)
    ci = lax.axis_index(col_axis)
    cn = lax.axis_size(col_axis)
    row_ids = jnp.arange(x.shape[0])[:, None]
    col_ids = jnp.arange(x.shape[1])[None, :]
    x = jnp.where((ri == 0) & (row_ids == 0), x[1:2], x)
    x = jnp.where((ri == rn - 1) & (row_ids == x.shape[0] - 1), x[-2:-1], x)
    x = jnp.where((ci == 0) & (col_ids == 0), x[:, 1:2], x)
    x = jnp.where((ci == cn - 1) & (col_ids == x.shape[1] - 1), x[:, -2:-1], x)
    return x


def extend_phase_2d(
    phase_local: jnp.ndarray, row_axis: str, col_axis: str
) -> jnp.ndarray:
    """Static phase block -> [h+2, w+2] extension, once per chunk."""
    return extend_2d(phase_local, row_axis, col_axis)


def halo_geometry_2d(
    row_axis: str, col_axis: str, phase_ext: Optional[jnp.ndarray] = None,
    dmap_ext: Optional[jnp.ndarray] = None,
) -> Geometry:
    """Geometry over [rows, cols]-sharded local blocks (2D mesh)."""
    return Geometry(
        laplace=partial(halo_laplace_2d, row_axis=row_axis,
                        col_axis=col_axis, phase_ext=phase_ext,
                        dmap_ext=dmap_ext),
        enforce_boundary=partial(halo_enforce_boundary_2d,
                                 row_axis=row_axis, col_axis=col_axis),
    )


def halo_exchange_step(model, axis_name: str, phase_ext=None):
    """Convenience: model.step specialized to the halo geometry."""
    geom = halo_geometry(axis_name, phase_ext)
    return lambda state: model.step(state, geom)
