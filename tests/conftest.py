"""Test configuration: the CPU backend with an 8-device virtual mesh.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default here), so
sharding and collective code paths run without several cards.  Tests
that only a GPU can run (compiled kernels) carry the `gpu` marker and
skip with a reason elsewhere; on a GPU machine they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Importing tpulc turns on the persistent compile cache (a per-machine
# partition of <checkout>/.jax_cache on the CPU, or
# JAX_COMPILATION_CACHE_DIR when set).
import tpulc  # noqa: E402,F401

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped when JAX's default device "
                   "is not one")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU
    (decided here, at run time, never at import or collection)."""
    if request.node.get_closest_marker("gpu"):
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; JAX's default device is {platform}")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap in-process XLA/LLVM state growth: after ~200 big CPU-backend
    compiles in one process the executable serializer aborts (observed
    as 'Fatal Python error: Aborted' in compilation_cache.put).  Module-
    scoped clearing keeps each module's jits shared while bounding the
    live-executable set; the persistent disk cache makes cross-module
    re-hits cheap."""
    yield
    jax.clear_caches()
