"""Persistent XLA compilation cache helper.

First compiles of NUTS-sized programs cost seconds to minutes; the
persistent cache lets later processes reuse them.  Call once before the
first compile.
"""

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Enable the persistent compilation cache (idempotent).

    Uses ``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``.
    Returns the directory used.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
