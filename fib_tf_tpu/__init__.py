"""fib_tf_tpu — a JAX cardiac electrophysiology framework (2D sheets,
3D volumes, ensembles).

A ground-up JAX/XLA re-design of the capabilities of the reference
TensorFlow-1.x framework (siravan/fib_tf): monodomain reaction-diffusion on a
2D finite-difference grid with explicit Euler, for the 4-variable
Cherry-Ehrlich-Nattel-Fenton, 8-variable Beeler-Reuter, and 21-variable
Courtemanche ionic models, plus the reference's optimization catalog
(Rush-Larsen, Chebyshev rate approximation, multi-rate integration,
voltage-indexed lookup tables, phase-field geometry) re-expressed as
compile-time variants of a single jitted `lax.scan` step loop, with GSPMD /
`shard_map` spatial sharding over device meshes.

Layering (cf. reference SURVEY.md §1):
  L0  native/          C++ lookup-table toolchain (generate_table)
  L1  JAX/XLA runtime  (implicit; `jax.jit`)
  L2  ops/ + engine/   numerics core + compiled run loop
  L3  models/          the ionic model zoo
  L4  utils/           profiling, checkpointing, visualization, electrograms
  L5  examples/ + cli  experiment scripts
"""

__version__ = "0.2.0"

from fib_tf_tpu.config import SimConfig

__all__ = ["SimConfig"]
