"""Multi-process (multi-host) runtime glue.

Within one host, sharding + collectives between its devices need no
user code beyond a Mesh (sharding.py / spmd.py).  Across hosts, JAX's
standard multi-process runtime carries the same program over the
network: each process calls `initialize()` (jax.distributed) at
startup, after which
`jax.devices()` spans the whole job and every Mesh built from it shards
globally.  There is no user-visible communication library — GSPMD/
shard_map remains the backend (SURVEY.md §5 'distributed communication').
"""

from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize the JAX distributed runtime (no-op if single-process).

    Pass the coordinator address (e.g. `localhost:<port>`), process
    count and this process's id explicitly where no cluster manager
    provides them.
    """
    import jax

    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(shape=None, axes=("x", "y")):
    """A mesh over every device in the (possibly multi-process) job."""
    from fib_tf_tpu.parallel.sharding import make_mesh

    return make_mesh(shape=shape, axes=axes)
