"""Test env: the CPU with 8 virtual devices, so the multi-device sharding
tests run without accelerators.  Must run before jax is imported.

`JAX_PLATFORMS` defaults to cpu.  The tests that need the card carry the
`gpu` marker and skip without one; on a GPU machine run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX finds none (decided here, at run
    time, never at import or collection)."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        pytest.skip(f"no GPU: {e}")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap per-process accumulation across the full suite: running all
    ~180 tests in one process piles up compiled CPU executables until a
    late XLA:CPU compile segfaults (reproducibly, at ~test 130; any
    subset of the suite passes).  Dropping the compiled-program caches
    at module boundaries keeps within-module reuse (where nearly all
    sharing is) and bounds the footprint."""
    yield
    import jax

    jax.clear_caches()
