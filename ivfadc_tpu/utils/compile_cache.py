"""Persistent XLA compilation cache location — the one place it is set.

The directory is part of every cache key's lookup path, so it must not
move between runs: it is `$JAX_COMPILATION_CACHE_DIR` when that is set
(JAX reads the variable itself), and otherwise `.jax_cache` at the root of
this checkout.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the compilation cache uses (see module docstring)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.
    Call before the first compilation; returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
