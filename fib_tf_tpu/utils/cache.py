"""Persistent XLA compilation cache.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed
`<checkout>/.jax_cache`: a fixed path, so that every run from one
checkout finds what an earlier run compiled.  Disable with
FIB_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os
from typing import Optional

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__)))),
    ".jax_cache",
)

_enabled = False


def cache_dir() -> Optional[str]:
    """The directory `enable` configures, or None where JAX takes it
    from `JAX_COMPILATION_CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_DIR


def enable() -> None:
    """Turn the persistent cache on for this process (idempotent).
    Call before the first compilation: JAX opens the cache once."""
    global _enabled
    if _enabled or os.environ.get("FIB_NO_COMPILE_CACHE"):
        return
    path = cache_dir()
    if path is not None:
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    _enabled = True
