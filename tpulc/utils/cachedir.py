"""Machine-partitioned JAX compilation-cache directories.

A checkout's CPU-backend cache can be reached from machines with
different CPU feature sets; foreign entries make XLA's
`cpu_aot_loader` report machine-feature mismatches (and can fail at
execution).  Partitioning the cache by a fingerprint of the local
CPU's feature flags keeps every machine's entries separate.
"""

from __future__ import annotations

import hashlib
import os
import platform


def machine_fingerprint() -> str:
    """Stable 12-hex-digit id for this machine's CPU feature set."""
    parts = [platform.machine(), platform.system()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        parts.append(platform.processor())
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def machine_cache_dir(root: str) -> str:
    """Per-machine subdirectory of a cache root (created if absent)."""
    d = os.path.join(root, "m-" + machine_fingerprint())
    os.makedirs(d, exist_ok=True)
    return d
