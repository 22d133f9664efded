"""Bit-granular packing/unpacking as data-parallel JAX ops.

The reference packs variable-length codes with per-thread serial loops
plus `atomicOr` into shared/global words (cudpp `huffman_kernel_en`,
`compress_kernel.cuh:2525-2716`; Dipperstein `bitfile.c`).  There are
no atomics in the XLA programming model and serial bit loops waste the
vector units, so packing is reformulated as:

    1. exclusive prefix-sum of the per-item bit lengths -> bit offsets,
    2. each item contributes to at most two 32-bit words (shift/mask),
    3. a segmented OR-scan over equal-word runs + one compaction sort
       assembles the words (no scatters).

The scatter-free assembly relies on two structural facts: bit offsets
are monotone, so all codes starting in word w form a contiguous run;
and any code is <= 32 bits, so every word in the used range contains at
least one code start (a code can cross at most one word boundary), and
at most one code crosses into each word — the last code of the
preceding word's run.  Word w is then `OR(lo of run w) | hi(last code
of run w-1)`, both available from one segmented scan; the per-word rows
compact to the front with a single key sort because run indices are
exactly 0..W_used-1.

Bit order convention (the whole framework uses it): MSB-first within a
32-bit unit, units in increasing order — the same convention as the
CUHD decoder's bit windows (`cuhd_gpu_decoder.cu:16-143`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def exclusive_cumsum(x: jax.Array) -> jax.Array:
    """Exclusive prefix sum along the last axis (same dtype as x)."""
    c = jnp.cumsum(x, axis=-1)
    return c - x


def pack_bits(codes: jax.Array, lengths: jax.Array, out_words: int):
    """Pack variable-length codes into a dense MSB-first bitstream.

    Args:
      codes: uint32[N] — each code right-aligned in the low `lengths[i]`
        bits (value < 2**lengths[i]).
      lengths: int32[N] — bit length per code, in [0, 32]. Zero-length
        items contribute nothing.
      out_words: static output size in 32-bit words. Must satisfy
        ``out_words*32 >= sum(lengths)``; callers size it from the max
        possible code length.

    Returns:
      (words, total_bits): uint32[out_words] dense stream, int32 scalar
      number of valid bits.
    """
    codes = codes.astype(_U32)
    lengths = lengths.astype(jnp.int32)
    n = codes.shape[0]
    if n == 0:
        return jnp.zeros((out_words,), _U32), jnp.int32(0)
    off = exclusive_cumsum(lengths)
    total_bits = off[-1] + lengths[-1]

    word = (off >> 5).astype(jnp.int32)
    bit = (off & 31).astype(jnp.int32)
    # Field occupies bits [bit, bit+len) of word `word` (MSB-first);
    # spill into word+1 when bit+len > 32.
    shift = 32 - bit - lengths                      # may be negative
    pos_shift = jnp.clip(shift, 0, 31).astype(_U32)
    neg_shift = jnp.clip(-shift, 0, 31).astype(_U32)
    lo = jnp.where(shift >= 0, codes << pos_shift, codes >> neg_shift)
    spill_shift = jnp.clip(32 + shift, 0, 31).astype(_U32)
    hi = jnp.where(shift < 0, codes << spill_shift, _U32(0))
    # Mask empty items entirely.
    nonzero = lengths > 0
    lo = jnp.where(nonzero, lo, _U32(0))
    hi = jnp.where(nonzero, hi, _U32(0))

    # Segmented inclusive OR over equal-`word` runs (word is monotone).
    first = jnp.concatenate(
        [jnp.ones((1,), bool), word[1:] != word[:-1]]
    )

    def comb(a, b):
        f1, v1 = a
        f2, v2 = b
        return f1 | f2, jnp.where(f2, v2, v1 | v2)

    _, or_incl = jax.lax.associative_scan(comb, (first, lo))
    is_end = jnp.concatenate(
        [word[:-1] != word[1:], jnp.ones((1,), bool)]
    )
    # Compact per-word rows to the front: run w's end-item gets key w,
    # everything else sorts behind the used range.
    key = jnp.where(is_end, word, jnp.int32(2 ** 30))
    key_c, or_c, hi_c = jax.lax.sort((key, or_incl, hi), num_keys=1)
    pad = max(0, out_words - n)
    zpad = jnp.zeros((pad,), _U32)
    big = jnp.full((pad,), 2 ** 30, jnp.int32)
    wi = jnp.arange(out_words, dtype=jnp.int32)
    # A word without any code start (possible only for the final word,
    # when the last code spills into it) has no run: its compacted row
    # is garbage, so gate rows on the key actually matching.
    has_run = jnp.concatenate([key_c, big])[:out_words] == wi
    or_w = jnp.where(has_run, jnp.concatenate([or_c, zpad])[:out_words],
                     _U32(0))
    hi_w = jnp.concatenate([hi_c, zpad])[:out_words]
    hi_prev = jnp.concatenate([jnp.zeros((1,), _U32), hi_w[:-1]])
    wused = (total_bits + 31) >> 5
    return jnp.where(wi < wused, or_w | hi_prev, _U32(0)), total_bits


def peek_bits(words: jax.Array, bitpos: jax.Array, width: int) -> jax.Array:
    """Read `width` (static, 1..32) bits at absolute MSB-first bit positions.

    `words` must have at least one padding word beyond the last bit read
    (the CUHD input buffer does the same +1-unit pad,
    `cuhd-icpp/src/cuhd_input_buffer.cc:17`).

    Returns uint32 values right-aligned in the low `width` bits.
    """
    w = (bitpos >> 5).astype(jnp.int32)
    b = (bitpos & 31).astype(_U32)
    hi = words[w]
    lo = words[w + 1]
    # Align the field so it starts at the MSB of a 32-bit register.
    lo_shift = jnp.clip(32 - b.astype(jnp.int32), 0, 31).astype(_U32)
    merged = (hi << b) | jnp.where(b > 0, lo >> lo_shift, _U32(0))
    return merged >> _U32(32 - width)


def byte_windows(words: jax.Array) -> jax.Array:
    """uint32[W] MSB-first words -> uint32[4W] sliding windows at byte
    granularity: out[i] = bits [8i, 8i+32) of the stream.

    Trades 4x memory for halving the gather count of bit-position reads:
    `peek_bits` needs two word gathers per probe (straddle), while a
    byte-granular window leaves at most 7 bits of misalignment — one
    gather plus a shift covers any width <= 25 (`peek_bits_bw`).
    """
    w = words.astype(_U32)
    nxt = jnp.concatenate([w[1:], jnp.zeros((1,), _U32)])
    vs = [w]
    for sh in (8, 16, 24):
        vs.append((w << _U32(sh)) | (nxt >> _U32(32 - sh)))
    return jnp.stack(vs, axis=1).reshape(-1)


def peek_bits_bw(bwin: jax.Array, bitpos: jax.Array, width: int) -> jax.Array:
    """Read `width` (static, 1..25) bits at absolute MSB-first positions
    from a `byte_windows` array — ONE gather per probe."""
    assert width <= 25
    idx = (bitpos >> 3).astype(jnp.int32)
    sh = (bitpos & 7).astype(_U32)
    return (bwin[idx] << sh) >> _U32(32 - width)


def bitreverse_u32(x: jax.Array, width: int) -> jax.Array:
    """Reverse the low `width` bits of each uint32 element."""
    x = x.astype(_U32)
    m1, m2, m4 = _U32(0x55555555), _U32(0x33333333), _U32(0x0F0F0F0F)
    x = ((x >> 1) & m1) | ((x & m1) << 1)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & _U32(0x00FF00FF)) | ((x & _U32(0x00FF00FF)) << 8)
    x = (x >> 16) | (x << 16)
    return x >> _U32(32 - width)


def bytes_to_words_msb(data: jax.Array, out_words: int | None = None) -> jax.Array:
    """uint8[N] -> uint32 words, MSB-first (big-endian within a word)."""
    n = data.shape[0]
    nw = (n + 3) // 4 if out_words is None else out_words
    padded = jnp.zeros((nw * 4,), jnp.uint8).at[:n].set(data)
    b = padded.reshape(nw, 4).astype(_U32)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def words_msb_to_bytes(words: jax.Array, n: int) -> jax.Array:
    """uint32 words (MSB-first) -> uint8[n]."""
    w = words.astype(_U32)
    b = jnp.stack(
        [(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], axis=1
    ).reshape(-1)
    return b[:n].astype(jnp.uint8)
