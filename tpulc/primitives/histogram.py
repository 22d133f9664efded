"""Byte histograms.

Replaces cudpp's shared-memory/atomic histogram kernel
(`huffman_build_histogram_kernel`, `compress_kernel.cuh:2037-2128`) with
a one-hot segment-sum, which XLA lowers to a scatter-add (or, batched,
a one-hot reduction).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def byte_histogram(data: jax.Array, num_bins: int = 256) -> jax.Array:
    """Histogram of uint8 data -> int32[num_bins]."""
    return jnp.zeros((num_bins,), jnp.int32).at[data.astype(jnp.int32)].add(
        1, mode="drop"
    )


def batched_byte_histogram(blocks: jax.Array, num_bins: int = 256) -> jax.Array:
    """Per-row histogram of uint8[B, N] -> int32[B, num_bins].

    Uses a one-hot reduction over the row.
    """
    onehot = jax.nn.one_hot(blocks.astype(jnp.int32), num_bins, dtype=jnp.float32)
    return jnp.sum(onehot, axis=1).astype(jnp.int32)
