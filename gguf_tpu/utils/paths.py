"""Fixed places in the checkout for what the program generates.

JAX's persistent compilation cache:

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and this module sets
no other directory. Otherwise the cache lives in `.jax_cache/` at the root
of the checkout (listed in `.gitignore`): a fixed path, because the path is
part of the cache key and a directory that moves never hits.

Generated checkpoints (random-weight smoke models) go to `.generated/` at
the root of the checkout, also listed in `.gitignore`.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at `compile_cache_dir()` and return it.
    Call before the first compilation of the process."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def generated_path(name: str) -> str:
    """Path of a generated file under `.generated/` (created on demand)."""
    d = os.path.join(CHECKOUT_ROOT, ".generated")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)
