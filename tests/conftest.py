"""Test harness: the CPU backend with 8 virtual devices, so the sharded
paths run without a GPU (SURVEY.md §4d), and no persistent compile cache.

The platform comes from JAX_PLATFORMS when it is set, so the `gpu`-marked
tests can run on a card: `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("FIB_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)
