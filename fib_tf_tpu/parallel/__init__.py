"""Multi-chip spatial domain decomposition (SURVEY.md §2 'parallelism').

The reference is strictly single-device (every graph pinned to one GPU,
fenton.py:126 etc.); the one parallelism this workload admits is sharding
the [H, W] grid across chips with 1-cell halo exchange per substep.  Here
that is first-class: GSPMD partitions the padded stencil automatically
(halos become collective-permutes between devices), and a `shard_map` variant
makes the halo exchange explicit for kernel-level control.
"""

from fib_tf_tpu.parallel.sharding import (
    make_mesh,
    plane_sharding,
    shard_state,
    shard_state_global,
)
from fib_tf_tpu.parallel.halo import halo_exchange_step

__all__ = [
    "make_mesh",
    "plane_sharding",
    "shard_state",
    "shard_state_global",
    "halo_exchange_step",
]
