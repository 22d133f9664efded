"""Fully parallel self-synchronizing Huffman decode.

A reformulation of the CUHD gap-array decoder
(`cuhd-icpp/src/cuhd_gpu_decoder.cu:16-420`).  CUHD runs four phases
with a host-driven resynchronization loop between thread blocks
(phases 1-2, `:145-327`) and a device scan (phase 3).  The key
observation that removes the sync loop entirely:

    A codeword straddles a subsequence boundary by at most L-1 bits
    (L = max codeword length), so the decoder state crossing any
    boundary is just "entry bit offset" in [0, L).  Decoding one
    subsequence from each of the L possible entry offsets yields a map
    f_i : [0,L) -> [0,L) plus a symbol count per entry.  Map
    composition is associative, so `lax.associative_scan` computes
    every subsequence's true entry offset and output position in
    O(log n) combine rounds — no iteration-to-convergence, no
    device->host round trips.

Phase 4 then decodes each subsequence once from its known entry offset,
scattering symbols at scanned output offsets (as CUHD phase 4,
`cuhd_gpu_decoder.cu:353-420`).

An "aligned" fast path is also provided for tpulc's own container,
which stores per-chunk bit offsets (like cudpp's per-block
`d_encodeOffset`, `include/cudpp.h:327`) and skips phases 1-3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpulc.primitives.bits import byte_windows, peek_bits, peek_bits_bw

DEFAULT_SUB_BITS = 512  # 16 x 32-bit units per subsequence


def _pad_words(words: jax.Array) -> jax.Array:
    return jnp.concatenate([words, jnp.zeros((2,), jnp.uint32)])


def _decode_maps(words_p, total_bits, lut_len, max_len: int, sub_bits: int, nsub: int):
    """Phase 1: per-subsequence entry->exit maps and symbol counts.

    Returns (next_map int32[nsub, L], count_map int32[nsub, L]).
    """
    L = max_len
    sub_start = (jnp.arange(nsub, dtype=jnp.int32) * sub_bits)[:, None]
    end = sub_start + sub_bits
    pos0 = sub_start + jnp.arange(L, dtype=jnp.int32)[None, :]
    cnt0 = jnp.zeros((nsub, L), jnp.int32)

    def cond(state):
        pos, _ = state
        return jnp.any((pos < end) & (pos < total_bits))

    def body(state):
        pos, cnt = state
        active = (pos < end) & (pos < total_bits)
        win = peek_bits(words_p, pos, L).astype(jnp.int32)
        step = lut_len[win].astype(jnp.int32)
        # A zero-length LUT entry means a corrupt stream; advance one bit
        # so the loop terminates (mirrors cuhd's implicit robustness).
        step = jnp.where(step == 0, 1, step)
        pos = pos + jnp.where(active, step, 0)
        cnt = cnt + active.astype(jnp.int32)
        return pos, cnt

    pos, cnt = jax.lax.while_loop(cond, body, (pos0, cnt0))
    next_map = jnp.clip(pos - end, 0, L - 1)
    return next_map, cnt


def _compose_scan(next_map, count_map):
    """Inclusive associative scan of (entry->exit, entry->count) maps."""

    def combine(a, b):
        an, ac = a
        bn, bc = b
        return (
            jnp.take_along_axis(bn, an, axis=-1),
            ac + jnp.take_along_axis(bc, an, axis=-1),
        )

    return jax.lax.associative_scan(combine, (next_map, count_map), axis=0)


def huffman_decode(
    words: jax.Array,
    total_bits: jax.Array,
    n_out: int,
    lut_sym: jax.Array,
    lut_len: jax.Array,
    max_len: int,
    sub_bits: int = DEFAULT_SUB_BITS,
    out_dtype=jnp.uint8,
):
    """Self-synchronizing parallel decode (no partition metadata needed).

    Args:
      words: uint32[W] MSB-first bitstream.
      total_bits: traced scalar, valid bit count.
      n_out: static output capacity (>= true symbol count).
      lut_sym/lut_len: flat 2^max_len decode LUT.
      max_len: L, static.
      sub_bits: static subsequence size in bits (multiple of 32).

    Returns:
      (out uint8[n_out], n_valid int32).
    """
    W = words.shape[0]
    nsub = -(-(W * 32) // sub_bits)
    words_p = _pad_words(words)
    lut_len = lut_len.astype(jnp.int32)

    next_map, count_map = _decode_maps(
        words_p, total_bits, lut_len, max_len, sub_bits, nsub
    )
    incl_next, incl_cnt = _compose_scan(next_map, count_map)
    # Exclusive prefix applied to the stream-initial state (entry 0).
    entry = jnp.concatenate([jnp.zeros((1,), jnp.int32), incl_next[:-1, 0]])
    offset = jnp.concatenate([jnp.zeros((1,), jnp.int32), incl_cnt[:-1, 0]])
    n_valid = incl_cnt[-1, 0]

    out = _decode_write(
        words_p, total_bits, n_out, lut_sym, lut_len, max_len, sub_bits,
        entry, offset, out_dtype,
    )
    return out, n_valid


def _decode_write(
    words_p, total_bits, n_out, lut_sym, lut_len, max_len, sub_bits,
    entry, offset, out_dtype=jnp.uint8,
):
    """Phase 4: single decode pass writing symbols at known offsets."""
    nsub = entry.shape[0]
    L = max_len
    sub_start = jnp.arange(nsub, dtype=jnp.int32) * sub_bits
    end = sub_start + sub_bits
    pos0 = sub_start + entry
    out0 = jnp.zeros((n_out,), out_dtype)

    def cond(state):
        pos, _, _ = state
        return jnp.any((pos < end) & (pos < total_bits))

    def body(state):
        pos, oidx, out = state
        active = (pos < end) & (pos < total_bits)
        win = peek_bits(words_p, pos, L).astype(jnp.int32)
        step = lut_len[win].astype(jnp.int32)
        step = jnp.where(step == 0, 1, step)
        sym = lut_sym[win].astype(out0.dtype)
        tgt = jnp.where(active, oidx, n_out)
        out = out.at[tgt].set(sym, mode="drop")
        pos = pos + jnp.where(active, step, 0)
        oidx = oidx + active.astype(jnp.int32)
        return pos, oidx, out

    _, _, out = jax.lax.while_loop(cond, body, (pos0, offset, out0))
    return out


def huffman_decode_aligned(
    words: jax.Array,
    total_bits: jax.Array,
    n_out: int,
    lut_sym: jax.Array,
    lut_len: jax.Array,
    max_len: int,
    chunk_bit_offsets: jax.Array,
    chunk_sym_offsets: jax.Array,
    sub_bits: int = DEFAULT_SUB_BITS,
    out_dtype=jnp.uint8,
):
    """Fast-path decode when the container carries per-chunk offsets.

    `chunk_bit_offsets[i]` / `chunk_sym_offsets[i]` give the absolute bit
    position and output index where chunk i starts; chunks are the
    encoder's fixed symbol groups, so no synchronization phase is needed
    (cudpp's `d_encodeOffset` scheme, `include/cudpp.h:327`).
    """
    del sub_bits  # chunk boundaries come from the offsets themselves
    nsub = chunk_bit_offsets.shape[0]
    words_p = _pad_words(words)
    lut_len = lut_len.astype(jnp.int32)
    ends = jnp.concatenate(
        [chunk_bit_offsets[1:], jnp.reshape(total_bits, (1,)).astype(jnp.int32)]
    )
    L = max_len
    pos0 = chunk_bit_offsets
    out0 = jnp.zeros((n_out,), out_dtype)

    def cond(state):
        pos, _, _ = state
        return jnp.any(pos < ends)

    def body(state):
        pos, oidx, out = state
        active = pos < ends
        win = peek_bits(words_p, pos, L).astype(jnp.int32)
        step = lut_len[win].astype(jnp.int32)
        step = jnp.where(step == 0, 1, step)
        sym = lut_sym[win].astype(out0.dtype)
        tgt = jnp.where(active, oidx, n_out)
        out = out.at[tgt].set(sym, mode="drop")
        pos = pos + jnp.where(active, step, 0)
        oidx = oidx + active.astype(jnp.int32)
        return pos, oidx, out

    _, _, out = jax.lax.while_loop(cond, body, (pos0, chunk_sym_offsets, out0))
    return out


def huffman_decode_uniform(
    words: jax.Array,
    total_bits: jax.Array,
    n_out: int,
    lut_sym: jax.Array,
    lut_len: jax.Array,
    max_len: int,
    chunk_bit_offsets: jax.Array,
    chunk_syms: int,
    out_dtype=jnp.uint8,
):
    """Aligned decode for UNIFORM chunks (chunk i starts at output index
    i*chunk_syms).  Output positions are then fully determined by the
    loop step, so each iteration writes one row of a step-major
    [chunk_syms, nchunks] matrix via dynamic_update_slice — no scatter
    at all (`huffman_decode_aligned` pays a scatter per step).  Symbol
    and length LUTs ride one packed table: one gather per step instead
    of two."""
    # packed entry: sym << 4 | len  (len <= 15)
    lut_packed = (
        (lut_sym.astype(jnp.int32) << 4) | lut_len.astype(jnp.int32)
    )
    return huffman_decode_uniform_packed(
        words, total_bits, n_out, lut_packed, max_len,
        chunk_bit_offsets, chunk_syms, out_dtype,
    )


def huffman_decode_uniform_packed(
    words: jax.Array,
    total_bits: jax.Array,
    n_out: int,
    lut_packed: jax.Array,
    max_len: int,
    chunk_bit_offsets: jax.Array,
    chunk_syms: int,
    out_dtype=jnp.uint8,
    lut_base: jax.Array | None = None,
):
    """`huffman_decode_uniform` taking the (sym << 4 | len) packed LUT
    directly (e.g. built on device by
    `device_tables.canonical_lut_packed`).

    `lut_base` (optional, int32[nsub]) selects a per-chunk table when
    `lut_packed` is K stacked LUTs flattened: chunk i reads entries
    `lut_packed[lut_base[i] + win]` (bzip2-style multi-table selectors,
    `compress.c:242-600`)."""
    nsub = chunk_bit_offsets.shape[0]
    assert nsub * chunk_syms >= n_out
    words_p = _pad_words(words)
    # Byte-granular windows: ONE gather per decode step instead of two
    # (the serial symbol loop is gather-latency-bound).
    bwin = byte_windows(words_p)
    L = max_len
    assert L <= 25
    ends = jnp.concatenate(
        [chunk_bit_offsets[1:],
         jnp.reshape(total_bits, (1,)).astype(jnp.int32)]
    )
    out0 = jnp.zeros((chunk_syms, nsub), out_dtype)

    def body(t, state):
        pos, out = state
        active = pos < ends
        win = peek_bits_bw(bwin, pos, L).astype(jnp.int32)
        if lut_base is not None:
            win = win + lut_base
        p = lut_packed[win]
        step = p & 15
        step = jnp.where(step == 0, 1, step)
        sym = jnp.where(active, p >> 4, 0).astype(out0.dtype)
        out = jax.lax.dynamic_update_slice(out, sym[None, :], (t, 0))
        pos = pos + jnp.where(active, step, 0)
        return pos, out

    _, out = jax.lax.fori_loop(0, chunk_syms, body,
                               (chunk_bit_offsets, out0), unroll=4)
    return out.T.reshape(-1)[:n_out]


# --- batched canonical rank decode (the CPU path) ---
#
# Canonical codes admit a table-free classifier: code length = smallest
# l whose l-bit window prefix v_l does not exceed the largest length-l
# code (monotone in l, so it is a sum of L compares), and the canonical
# RANK is v_len + (base[len] - first[len]) — arithmetic from 12
# broadcast scalars per block.  One byte-window gather then yields TWO
# symbols (<= 2*12 bits fit a 25-bit peek), and the rank->symbol
# permutation is applied once at the end.  Decoding B blocks in ONE
# program turns the per-step work into [B, ccap]-wide vector steps.
# On the GPU the walk runs as one thread per chunk instead
# (`pallas_decode.walk_chunks`).


def canonical_params_device(lengths, max_len: int):
    """lengths int32[B, 256] -> (limit f[B,L+1], sub [B,L+1], order
    [B,256]): largest code per length, rank adjustment per length, and
    symbols in canonical (length, symbol) order."""
    L = max_len
    lvals = jnp.arange(L + 1, dtype=jnp.int32)
    cnt = (lengths[:, :, None] == lvals[None, None, :]).sum(
        axis=1
    ).astype(jnp.int32)                       # [B, L+1]; cnt[:,0] unused
    firsts = [jnp.zeros_like(cnt[:, 0]), jnp.zeros_like(cnt[:, 0])]
    for l in range(1, L):
        firsts.append((firsts[l] + cnt[:, l]) << 1)
    first = jnp.stack(firsts, axis=1)         # [B, L+1]
    base = jnp.cumsum(cnt, axis=1) - cnt      # codes with shorter length
    base = base - cnt[:, 0:1]                 # exclude length-0 symbols
    limit = first + cnt - 1
    sub = base - first
    sym = jnp.arange(256, dtype=jnp.int32)[None, :]
    key = jnp.where(lengths > 0, lengths * 256 + sym, (1 << 20) + sym)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    return limit, sub, order


def _rank_of_window(w12, limit, sub, max_len: int):
    """[B, S] 12-bit windows -> (len, rank) via L broadcast compares."""
    L = max_len
    ln = jnp.ones_like(w12)
    for l in range(1, L):
        ln = ln + (w12 >> (L - l) > limit[:, l:l + 1]).astype(jnp.int32)
    ln = jnp.minimum(ln, L)
    v = w12 >> (L - ln)
    adj = jnp.zeros_like(w12)
    for l in range(1, L + 1):
        adj = jnp.where(ln == l, sub[:, l:l + 1], adj)
    rank = jnp.clip(v + adj, 0, 255)
    return ln, rank


def huffman_decode_ranks_batch(
    words: jax.Array,          # uint32 [B, w_pad]
    total_bits: jax.Array,     # int32 [B]
    lengths: jax.Array,        # int32 [B, 256]
    chunk_bit_offsets: jax.Array,  # int32 [B, ccap]
    chunk_syms: int,
    max_len: int,
):
    """Aligned-chunk decode of a whole block batch in one program.

    Returns uint8 [B, ccap * chunk_syms] decoded symbols (positions
    past each block's symbol count hold garbage; caller trims).
    """
    assert chunk_syms % 2 == 0 and max_len <= 12
    B, w_pad = words.shape
    ccap = chunk_bit_offsets.shape[1]
    limit, sub, order = canonical_params_device(lengths, max_len)
    bwin = jax.vmap(byte_windows)(
        jnp.concatenate([words, jnp.zeros((B, 2), jnp.uint32)], axis=1)
    )                                          # [B, 4*(w_pad+2)]
    ends = jnp.concatenate(
        [chunk_bit_offsets[:, 1:], total_bits[:, None]], axis=1
    )                                          # [B, ccap]
    pos0 = chunk_bit_offsets
    out0 = jnp.zeros((chunk_syms, B, ccap), jnp.int32)
    L = max_len

    def body(t, state):
        pos, out = state
        a1 = pos < ends
        idx = (pos >> 3).astype(jnp.int32)
        sh = (pos & 7).astype(jnp.uint32)
        w25 = ((jnp.take_along_axis(bwin, idx, axis=1) << sh)
               >> jnp.uint32(7)).astype(jnp.int32)   # 25-bit window
        ln1, r1 = _rank_of_window(w25 >> (25 - L), limit, sub, L)
        pos2 = pos + jnp.where(a1, ln1, 0)
        a2 = pos2 < ends
        w12b = (w25 >> (25 - L - ln1)) & ((1 << L) - 1)
        ln2, r2 = _rank_of_window(w12b, limit, sub, L)
        pos = pos2 + jnp.where(a2, ln2, 0)
        pair = jnp.stack([jnp.where(a1, r1, 0), jnp.where(a2, r2, 0)])
        out = jax.lax.dynamic_update_slice(out, pair, (2 * t, 0, 0))
        return pos, out

    _, ranks = jax.lax.fori_loop(0, chunk_syms // 2, body, (pos0, out0),
                                 unroll=2)
    # [chunk_syms, B, ccap] -> [B, ccap*chunk_syms] symbol stream order
    ranks = ranks.transpose(1, 2, 0).reshape(B, ccap * chunk_syms)
    # rank -> symbol as a one-hot contraction (exact: ranks and symbols
    # are < 256); lax.map over blocks bounds the one-hot working set to
    # [n, 256] bf16 per step.
    def _map_one(args):
        r, o = args
        oh = jax.nn.one_hot(r, 256, dtype=jnp.bfloat16)
        return jnp.matmul(oh, o.astype(jnp.bfloat16),
                          precision=jax.lax.Precision.HIGHEST)

    syms = jax.lax.map(_map_one, (ranks, order))
    return syms.astype(jnp.int32).astype(jnp.uint8)
