"""Test configuration: an 8-device CPU platform by default.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(mesh-batched filtering, particle- and mixture-sharded filters, the
time-sharded scan) are exercised without a GPU. ``JAX_PLATFORMS`` set in the
environment wins: tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``, and skip elsewhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU device for tests marked ``gpu``; skips when JAX has none.
    Decided here, at run time, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_files():
    """Bound per-process compile-cache growth: the full suite is ~1000 XLA
    CPU compiles, and a single process can crash inside backend_compile
    once enough executables accumulate. Belt next to the per-file xdist
    workers (pyproject addopts)."""
    yield
    jax.clear_caches()
