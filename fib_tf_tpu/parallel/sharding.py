"""Mesh construction and GSPMD shardings for the [H, W] state grid.

Design (scaling-book recipe): pick a mesh, annotate the state sharding, let
XLA insert the halo collectives.  For a 9-point stencil on a row-sharded
grid, GSPMD partitions the REFLECT-pad + shifted-slice pattern into local
stencil work plus one collective-permute of a 1-row halo per neighbor per
substep — the traffic between devices is H-halo only, identical to what
a hand-written exchange would ship.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = ("x", "y"),
    devices: Optional[Sequence] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """Build a device mesh.

    Default: all available devices in a 1D row mesh `('x',)`; pass
    `shape=(4, 2)` for a 2D rows x cols decomposition.  `n_devices`
    requests exactly that many devices and raises if fewer exist —
    a `devices[:n]` slice would otherwise silently build a smaller mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) are available "
                f"(platform={devices[0].platform if devices else 'none'}); "
                "refusing to silently shrink"
            )
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),)
        axes = axes[: 1]
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not match {len(devices)} devices"
        )
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axes[: len(shape)])


def plane_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of one [H, W] state plane over the mesh: H over the first
    axis, W over the second (if present)."""
    if len(mesh.axis_names) == 1:
        return NamedSharding(mesh, P(mesh.axis_names[0]))
    return NamedSharding(mesh, P(mesh.axis_names[0], mesh.axis_names[1]))


def shard_state(state: Dict[str, np.ndarray], mesh: Mesh):
    """Place every plane of a state pytree with the grid sharding."""
    sh = plane_sharding(mesh)
    return {k: jax.device_put(v, sh) for k, v in state.items()}


def shard_state_global(state: Dict[str, np.ndarray], mesh: Mesh):
    """Multi-process variant of shard_state: build global arrays from the
    (replicated, deterministic) host state via make_array_from_callback —
    each process materializes only its addressable shards.  Use under
    `jax.distributed` where `jax.device_put` cannot place onto
    non-addressable devices."""
    sh = plane_sharding(mesh)

    def put(v):
        v = np.asarray(v)
        return jax.make_array_from_callback(v.shape, sh, lambda idx: v[idx])

    return {k: put(v) for k, v in state.items()}
