"""Persistent XLA compilation cache for every veloslam_tpu entry point.

A cold process compiles every distinct program, and the batched full-SLAM
path (decode → odometry → device finalize → host tail) compiles dozens.
JAX's persistent compilation cache serializes compiled executables to
disk keyed on (HLO, compile options, backend version), so a later process
on the same machine — a rerun of the bench, the CLI apps — loads them
instead of recompiling.

Placement: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it
itself; nothing else is configured), else `<checkout>/.jax_cache`, a fixed
path so the cache key stays stable across runs.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where compiled programs land: the environment's choice, else the
    checkout's `.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str | None:
    """Point JAX's persistent compilation cache at `cache_dir()`.  Returns
    the directory, or None on CPU backends.  Must run before the first jit
    compilation to cover it, and initializes the backend to find out which
    it is — pin the platform first.

    CPU backends are deliberately excluded: XLA:CPU compiles quickly, and
    its AOT cache entries embed host machine features — reloading them on
    a host with different features risks SIGILL."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
