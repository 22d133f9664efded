"""The one place that names the platform tpulc runs on.

Code that takes a platform-specific path asks `platform()` at trace or
call time, never while a module is being imported.  A backend that
fails to initialise raises; nothing here falls back to the CPU.
"""

from __future__ import annotations

import jax

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """"gpu" or "cpu", from the default JAX device; raises on any other
    platform and on a backend that fails to initialise."""
    name = jax.devices()[0].platform
    if name not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: tpulc runs on "
            + " or ".join(SUPPORTED))
    return name


def on_gpu() -> bool:
    return platform() == "gpu"
