"""Parallel Huffman encode on device.

cudpp encodes per 4096-char block with per-thread serial bit counts, an
intra-block serial offset sum, and atomicOr packing
(`huffman_kernel_en`, `compress_kernel.cuh:2525-2716`).  The version here
is one global op chain with no atomics and no block partitioning:

    gather (code, len) per byte  ->  exclusive cumsum of lengths
    ->  disjoint-bit scatter-add into 32-bit words  (primitives.bits)

The whole thing is a single fused XLA program; HBM traffic is the bound.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpulc.primitives.bits import pack_bits


def huffman_encode(
    data: jax.Array,
    codes: jax.Array,
    lengths: jax.Array,
    out_words: int,
):
    """Encode uint8[N] with per-symbol (codes, lengths) tables.

    Args:
      data: uint8[N].
      codes: uint32[S] right-aligned canonical codes.
      lengths: int32[S] code lengths.
      out_words: static output word count (>= ceil(N*max_len/32)).

    Returns:
      (words uint32[out_words], total_bits int32).
    """
    idx = data.astype(jnp.int32)
    sym_codes = codes[idx]
    sym_lens = lengths[idx]
    return pack_bits(sym_codes, sym_lens, out_words)
