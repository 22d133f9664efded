"""Suffix array construction on `lax.sort` (prefix doubling).

The JAX equivalent of cudpp's `cudppSuffixArray` (recursive DC3 skew on
cub radix sorts, `sa_app.cu:125-365`): SURVEY.md §7 sanctions either
lax.sort-based DC3 or prefix-doubling; doubling is the better XLA fit —
fixed-shape loop state, one stable two-key sort per round, early exit
once ranks are unique (the same machinery as the rotation-sort BWT,
with end-of-string sentinels instead of wraparound).

Also provides the BWT-from-SA finalization (`bwt_compute_final_kernel`,
`compress_kernel.cuh:56-74`) for suffix-based (non-rotation) BWT uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def suffix_array(data: jax.Array) -> jax.Array:
    """SA of uint8[n]: SA[j] = start of the j-th smallest suffix."""
    from tpulc.codecs.bwt.rotsort import _scatter_perm

    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    byte = data.astype(jnp.int32)
    b_sorted, order0 = jax.lax.sort((byte, idx), num_keys=1, is_stable=True)
    grp0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         (b_sorted[1:] != b_sorted[:-1]).astype(jnp.int32)]
    )
    rank0 = _scatter_perm(order0, jnp.cumsum(grp0))

    def cond(state):
        rank, k = state
        return (k < n) & (jnp.max(rank) < n - 1)

    def body(state):
        rank, k = state
        # suffix i+k runs off the end -> rank -1 (sorts first, shorter
        # suffix is smaller)
        key2 = jnp.where(idx + k < n, jnp.roll(rank, -k), -1)
        r1, r2, order = jax.lax.sort(
            (rank, key2, idx), num_keys=2, is_stable=True
        )
        newgrp = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(jnp.int32)]
        )
        rank = _scatter_perm(order, jnp.cumsum(newgrp))
        return rank, k * 2

    rank, _ = jax.lax.while_loop(cond, body, (rank0, jnp.int32(1)))
    _, sa = jax.lax.sort((rank, idx), num_keys=1, is_stable=True)
    return sa


@jax.jit
def sa_to_bwt(data: jax.Array, sa: jax.Array):
    """cudpp-style BWT finalization: bwt[j] = data[SA[j]-1] (wrap),
    index = position of SA[j]==0 (`compress_kernel.cuh:56-74`)."""
    n = data.shape[0]
    bwt = data[(sa - 1) % n]
    idx0 = jnp.argmax(sa == 0).astype(jnp.int32)
    return bwt, idx0


def suffix_array_np(data) -> "np.ndarray":
    """Naive gold (cudpp `computeSaGold` role, `sa_gold.cpp:42`)."""
    import numpy as np

    arr = bytes(np.asarray(data, np.uint8))
    return np.asarray(
        sorted(range(len(arr)), key=lambda i: arr[i:]), np.int32
    )
