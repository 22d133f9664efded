"""Parallel LZSS encoder emitting the Dipperstein 12/4 bitstream.

Replaces the reference's brute-force window scans (CULZSS `FindMatch`
`gpu_compress.cu:104`, O(window) per char; lzss-0.6.2 `brute.c:92`)
with sort-based candidate discovery, and the serial greedy parse with
pointer-doubling reachability:

  1. every position's 3-byte prefix is an exact 24-bit key; one stable
     `lax.sort` of (key, pos) groups identical 3-grams by position, so
     each position's K most recent same-prefix predecessors are its
     match candidates (replacing hash chains);
  2. match extension compares the next 15 bytes vectorized; window and
     cursor constraints clamp the length;
  3. greedy tokenization = the orbit of position 0 under
     p -> p + token_len(p), computed in log2(n) scatter/gather rounds;
  4. tokens pack via prefix-sum bit offsets (primitives.bits) directly
     in the reference bit layout (flag, low-8/high-4 offset, len-3).

The virtual 4096-byte space-filled initial window (`lzencode.c:165`)
is materialized as a prefix so early matches against it work exactly
like the reference's.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpulc.primitives.bits import pack_bits
from tpulc.primitives.parallel import orbit_flags

WINDOW = 4096
MAX_CODED = 18
MAX_UNCODED = 2
_EXT = MAX_CODED - 3  # bytes to compare beyond the 3-gram


def _chain_candidates(key: jax.Array, n_total: int, k_cand: int):
    """k most recent predecessors sharing `key`, via one stable sort."""
    idx = jnp.arange(n_total, dtype=jnp.int32)
    skey, spos = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
    cands = []
    for d in range(1, k_cand + 1):
        prev_pos = jnp.roll(spos, d)
        prev_key = jnp.roll(skey, d)
        valid = (idx >= d) & (prev_key == skey)
        cands.append(jnp.where(valid, prev_pos, -1))
    cand_sorted = jnp.stack(cands, axis=1)  # [n_total, k] in sorted order
    out = jnp.full((n_total, k_cand), -1, jnp.int32)
    return out.at[spos].set(cand_sorted)


def _match_candidates(padded: jax.Array, n_total: int, k_cand: int):
    """Candidate sources per position: the k most recent exact-3-gram
    predecessors plus k/2 recent 7-gram-hash predecessors (long matches
    in high-frequency contexts live beyond any practical 3-gram chain
    depth; the longer-gram chain reaches them directly — all candidates
    are byte-verified afterwards, so hash collisions are harmless)."""
    p3 = padded.astype(jnp.int32)
    idx = jnp.arange(n_total, dtype=jnp.int32)
    key3 = (p3 << 16) | (jnp.roll(p3, -1) << 8) | jnp.roll(p3, -2)
    key3 = jnp.where(idx < n_total - 2, key3, (1 << 24) + idx)
    c3 = _chain_candidates(key3, n_total, k_cand)

    pu = padded.astype(jnp.uint32)
    h = jnp.zeros((n_total,), jnp.uint32)
    for j in range(7):
        h = (h * jnp.uint32(0x9E3779B1)) ^ jnp.roll(pu, -j)
    key7 = jnp.where(
        idx < n_total - 6, (h >> 2).astype(jnp.int32), (1 << 30) + idx
    )
    c7 = _chain_candidates(key7, n_total, max(1, k_cand // 2))
    return jnp.concatenate([c3, c7], axis=1)


def _exact_best_match(padded: jax.Array, n_total: int, n: int):
    """Exact longest match (3..18) per data position, brute.c-parity
    lengths, via incremental l-gram ranks: one stable sort per length.

    For length l, positions sharing an l-gram form groups; within a
    group the d-th sort predecessor is the d-th most recent earlier
    occurrence, and since recency distances are distinct integers, the
    nearest source with distance >= l appears within the first l
    predecessors.  Dense group ranks seed the next length's key
    (rank*256 + next byte), so each length costs exactly one sort.
    """
    idx = jnp.arange(n_total, dtype=jnp.int32)
    p3 = padded.astype(jnp.int32)
    key = (p3 << 16) | (jnp.roll(p3, -1) << 8) | jnp.roll(p3, -2)
    key = jnp.where(idx < n_total - 2, key, (1 << 25) + idx)

    pos_pad = jnp.arange(n, dtype=jnp.int32) + WINDOW
    best_len = jnp.zeros((n,), jnp.int32)
    best_src = jnp.zeros((n,), jnp.int32)

    for l in range(3, MAX_CODED + 1):
        skey, spos = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
        # nearest source with recency distance >= l (scan d descending so
        # the closest valid predecessor wins the final where)
        src = jnp.full((n_total,), -1, jnp.int32)
        for d in range(l, 0, -1):
            prev_pos = jnp.roll(spos, d)
            ok = (idx >= d) & (jnp.roll(skey, d) == skey) & (
                spos - prev_pos >= l
            )
            src = jnp.where(ok, prev_pos, src)
        # dense rank of the l-gram groups -> next key
        grp = jnp.concatenate(
            [
                jnp.zeros((1,), jnp.int32),
                (skey[1:] != skey[:-1]).astype(jnp.int32),
            ]
        )
        # un-permute src and rank in ONE key-value sort (instead of two
        # scatters per length)
        _, src_lin, rank = jax.lax.sort(
            (spos, src, jnp.cumsum(grp)), num_keys=1
        )
        s = src_lin[WINDOW: WINDOW + n]          # pos_pad is iota+WINDOW
        valid = (s >= 0) & (s >= pos_pad - WINDOW) & (
            (pos_pad - WINDOW) + l <= n
        )
        best_len = jnp.where(valid, l, best_len)
        best_src = jnp.where(valid, s, best_src)
        if l < MAX_CODED:
            nxt = jnp.roll(p3, -l)
            key = rank * 256 + jnp.where(idx < n_total - l, nxt, 0)
            key = jnp.where(idx < n_total - l, key, (1 << 30) + idx)
    return best_len, best_src


def _stitched_best(padded: jax.Array, n: int):
    """Best ring-wrapping match per position (brute.c can match sources
    whose ring segment crosses windowHead: the first c bytes come from
    the newest window bytes, the rest wrap to bytes 4096 earlier).
    Returns (len, src) with src = linear start of the first segment."""
    pos = jnp.arange(n, dtype=jnp.int32) + WINDOW
    best_len = jnp.zeros((n,), jnp.int32)
    best_src = jnp.zeros((n,), jnp.int32)
    # All index vectors here are iota + static shift, so every read is a
    # STATIC SLICE of `padded` — the previous gather form lowered to
    # ~300 full-size per-element gathers and dominated exact-mode
    # encode time.
    cur = [padded[WINDOW + j: WINDOW + j + n] for j in range(MAX_CODED)]
    for c in range(1, MAX_CODED):
        still = jnp.ones((n,), bool)
        ln = jnp.zeros((n,), jnp.int32)
        for j in range(MAX_CODED):
            srcb = (padded[WINDOW - c + j: WINDOW - c + j + n]
                    if j < c else padded[j - c: j - c + n])
            still = still & (srcb == cur[j])
            ln = ln + still.astype(jnp.int32)
        # only a true stitch (first segment fully matched) may exceed c
        ln = jnp.minimum(ln, jnp.where(ln >= c, MAX_CODED, c))
        ln = jnp.minimum(ln, n - (pos - WINDOW))
        take = ln > best_len
        best_len = jnp.where(take, ln, best_len)
        best_src = jnp.where(take, pos - c, best_src)
    return best_len, best_src


@partial(jax.jit, static_argnames=("k_cand", "out_words", "exact"))
def lzss_encode_device(data: jax.Array, k_cand: int, out_words: int,
                       exact: bool = False, n_valid: jax.Array | None = None):
    """Encode uint8[n] -> (words uint32[out_words], total_bits int32).

    The emitted bitstream is decodable by the reference lzss-0.6.2
    decoder byte-for-byte (zero-padded final byte, as bitfile does).

    `n_valid` (traced, default n) truncates the stream to the tokens
    whose start position is < n_valid: the driver pads tail blocks to a
    power-of-two capacity (ONE compiled program per bucket instead of
    one per stray tail length) and the decoder then yields >= n_valid
    bytes whose prefix is exact — the final kept token may overshoot
    into padding, which the caller trims (tokens never overlap their
    source, so every copied byte is part of the already-decoded
    prefix).
    """
    n = data.shape[0]
    pad_tail = MAX_CODED + 2  # so vectorized extension never reads OOB
    padded = jnp.concatenate(
        [
            jnp.full((WINDOW,), 32, jnp.uint8),
            data,
            jnp.zeros((pad_tail,), jnp.uint8),
        ]
    )
    n_total = n + WINDOW + pad_tail

    pos_pad = jnp.arange(n, dtype=jnp.int32) + WINDOW  # data positions
    if exact:
        best_len, best_src = _exact_best_match(padded, n_total, n)
        st_len, st_src = _stitched_best(padded, n)
        take = st_len > best_len
        best_len = jnp.where(take, st_len, best_len)
        best_src = jnp.where(take, st_src, best_src)
    else:
        cand = _match_candidates(padded, n_total, k_cand)  # [n, K + K//2]
        # Packed-word extension: comparing candidates byte-by-byte cost
        # ~36 full-size gathers per candidate (the dominant cost of the
        # whole encoder); 4 bytes per packed u32 word cuts the src-side
        # gathers to 5, and the cursor side is contiguous so its words
        # are static slices (free).
        pu = padded.astype(jnp.uint32)
        w4 = (
            (pu << 24) | (jnp.roll(pu, -1) << 16)
            | (jnp.roll(pu, -2) << 8) | jnp.roll(pu, -3)
        )
        wp = [w4[WINDOW + 4 * k: WINDOW + 4 * k + n] for k in range(5)]
        best_len = jnp.zeros((n,), jnp.int32)
        best_src = jnp.zeros((n,), jnp.int32)
        for kk in range(cand.shape[1]):
            src = cand[WINDOW: WINDOW + n, kk]
            valid = src >= 0
            srcc = jnp.maximum(src, 0)
            ln = jnp.zeros((n,), jnp.int32)
            still = valid
            for k in range(5):
                x = w4[srcc + 4 * k] ^ wp[k]
                mb = jnp.minimum(
                    jax.lax.clz(x).astype(jnp.int32) >> 3, 4
                )
                ln = ln + jnp.where(still, mb, 0)
                still = still & (x == 0)
            ln = jnp.minimum(ln, MAX_CODED)
            # window constraint and no overlap with the cursor
            in_window = (src >= pos_pad - WINDOW) & (src >= 0)
            ln = jnp.where(in_window, jnp.minimum(ln, pos_pad - src), 0)
            # clamp to remaining input
            ln = jnp.minimum(ln, n - (pos_pad - WINDOW))
            take = ln > best_len
            best_len = jnp.where(take, ln, best_len)
            best_src = jnp.where(take, src, best_src)

    is_match = best_len > MAX_UNCODED
    step = jnp.where(is_match, best_len, 1)

    # Greedy parse: orbit of 0 under p -> p + step[p] (gather-only
    # path-doubling enumeration, primitives.parallel.orbit_flags).
    jump = jnp.minimum(jnp.arange(n, dtype=jnp.int32) + step, n)
    jump_e = jnp.concatenate([jump, jnp.full((1,), n, jnp.int32)])
    is_start = orbit_flags(jump_e, n, n)

    # Token codes in the reference bit layout.
    off_ring = best_src % WINDOW
    adj = jnp.clip(best_len - (MAX_UNCODED + 1), 0, 15)
    match_code = (
        ((off_ring & 0xFF) << 8) | (((off_ring >> 8) & 0xF) << 4) | adj
    )
    lit_code = (1 << 8) | data.astype(jnp.int32)
    code = jnp.where(is_match, match_code, lit_code).astype(jnp.uint32)
    if n_valid is not None:
        is_start = is_start & (jnp.arange(n, dtype=jnp.int32) < n_valid)
    nbits = jnp.where(is_start, jnp.where(is_match, 17, 9), 0)
    return pack_bits(code, nbits, out_words)
