"""JAX's persistent compilation cache, kept in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to ``.jax_cache`` at the root
of the checkout this file belongs to, resolved from the file's own location
(a fixed path: the directory is part of the cache key, so a cache that
moves never hits).
"""

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Turn the persistent cache on; returns the directory it uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
