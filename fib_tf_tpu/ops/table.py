"""Voltage-indexed rate lookup tables.

The reference's native CUDA path precomputes the 30 voltage-dependent
Courtemanche intermediates into a 150x30 table at 1 mV resolution, indexed
by `clamp(int(V + 100), 0, 149)` with no interpolation
(courtemanche.h:352-357, 473-479; ionic.h:48-49), generated offline by
generate_table.cpp.

Here the table is a small compile-time constant and the per-cell row
select is a `jnp.take` gather.  The table itself can come
from either the Python rate functions or the C++ generator tool in
`fib_tf_tpu/native/` (the two are cross-checked in tests).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import jax.numpy as jnp
import numpy as np

TABLE_ROWS = 150       # ionic.h:48
V_OFFSET = 100.0       # row index = int(V + 100), courtemanche.h:354


def build_table(
    calc_inter: Callable[[np.ndarray], Dict[str, np.ndarray]],
    keys: Sequence[str],
    rows: int = TABLE_ROWS,
    v_offset: float = V_OFFSET,
) -> np.ndarray:
    """Tabulate `calc_inter` at V = i - v_offset for i in [0, rows).

    Equivalent of init_table<Courtemanche> (courtemanche.h:473-479), with
    columns ordered by `keys`.
    Returns a float32 [rows, len(keys)] array.
    """
    v = np.arange(rows, dtype=np.float64) - v_offset
    inter = calc_inter(v)
    cols = [np.broadcast_to(np.asarray(inter[k], dtype=np.float64), v.shape)
            for k in keys]
    return np.stack(cols, axis=1).astype(np.float32)


def row_index(v: jnp.ndarray, rows: int = TABLE_ROWS,
              v_offset: float = V_OFFSET) -> jnp.ndarray:
    """clamp(int(V + offset), 0, rows-1) (courtemanche.h:354-356).

    Matches C's float->int truncation toward zero via astype(int32).
    """
    i = (v + v_offset).astype(jnp.int32)
    return jnp.clip(i, 0, rows - 1)


def lookup(
    table: jnp.ndarray, v: jnp.ndarray, keys: Sequence[str]
) -> Dict[str, jnp.ndarray]:
    """Gather table rows for a voltage field and unpack to a dict.

    `table` is [rows, n_cols]; `v` is any-shaped voltage array; the result
    maps each key to an array shaped like `v`.
    """
    idx = row_index(v, table.shape[0])
    # [..., n_cols] gather from a 150x30 f32 table (18 KB)
    picked = jnp.take(table, idx, axis=0)
    return {k: picked[..., j] for j, k in enumerate(keys)}


def load_native_table(path: str, n_cols: int) -> np.ndarray:
    """Load a table emitted by the C++ generator (one float per line,
    row-major), the native generate_table toolchain's output format."""
    flat = np.loadtxt(path, dtype=np.float64)
    if flat.size % n_cols != 0:
        raise ValueError(
            f"table size {flat.size} not divisible by {n_cols} columns"
        )
    return flat.reshape(-1, n_cols).astype(np.float32)
