"""Dynamic-length block-sorting pipeline at fixed compiled shape.

BWT cannot run on zero-padded data as-is (padding changes the
rotations), but recompiling per data length is prohibitive.
These variants take a fixed capacity `cap` and a traced valid length
`n` (the bsc-class codec's LZP output length and the .bz2 emitter's
RLE1 block lengths are data dependent — SURVEY.md §2.5/2.6).

Design (same rules as `rotsort`): sorts and contiguous slices rather
than random gathers/scatters.  The wraparound read ``rank[(i + k) mod n]`` is NOT a gather here: the
rank vector is copied into a doubled buffer (one dynamic_update_slice)
and every composed key becomes a `dynamic_slice` at traced offset
``(j*k) mod n`` — so a fan-F refinement round costs one copy, F-1
slices, one (F+2)-operand sort and one key-value-sort scatter, all
O(n log n)-free of random access.

The inverse offers the same anchored decode as `rotsort`
(`bwt_decode_anchored`): strided restart rows recorded at encode time
(libbsc's parallel-unbwt restart indexes, `bwt.cpp:359`) turn the LF
walk into S-step lane walks; the pointer-doubling fallback handles
blocks whose refinement exhausted the depth budget (periodic data).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpulc.codecs.bwt.rle import rle2_encode, rle2_decode
from tpulc.codecs.bwt.rotsort import _FAN, _scatter_perm, _tied_rows
from tpulc.primitives.mtf import mtf_encode, mtf_decode

ANCHOR_STRIDE = 512


def _doubled(x, n, fill):
    """[cap] -> [2*cap] with x[0:n] duplicated at [n, 2n) (entries past
    2n are unread garbage).  One dynamic_update_slice, no gathers."""
    cap = x.shape[0]
    buf = jnp.concatenate([x, jnp.full((cap,), fill, x.dtype)])
    return jax.lax.dynamic_update_slice(buf, x, (n,))


def _wrap_slice(x2, off, cap):
    """x2 doubled buffer, traced offset in [0, n): rows i -> x2[i+off]."""
    return jax.lax.dynamic_slice(x2, (off,), (cap,))


def _zero_run_mask_masked(data, idx, n):
    """Boundary zero run of the VALID region (cyclic through n-1 -> 0);
    see rotsort._zero_run_mask for why ties inside it are benign."""
    real = idx < n
    nz = real & (data != 0)
    any_nz = jnp.any(nz)
    first_nz = jnp.argmax(nz).astype(jnp.int32)
    # last nonzero among the valid prefix
    last_nz = jnp.max(jnp.where(nz, idx, -1))
    in_run = real & ((idx > last_nz) | (idx < first_nz)) & any_nz
    return in_run.astype(jnp.int32)


def _refine_ranks_masked(data, idx, n, benign_ties: bool = True):
    """Rotation ranks of the n-length string at capacity cap.

    Padding rows get unique ranks AFTER every real rank and never move.
    Returns (rank int32[cap], done bool) — `done` as in
    rotsort._refine_ranks.
    """
    cap = data.shape[0]
    real = idx < n
    nn = jnp.maximum(n, 1)
    run = (_zero_run_mask_masked(data, idx, n) if benign_ties
           else jnp.zeros((cap,), jnp.int32))

    # Initial ranks from the 8-byte cyclic prefix (two packed u32 keys,
    # rotsort trajectory 8 -> 64 -> 512): doubled data buffer, wrap
    # slices; padding sorts after everything (primary key).
    d2 = _doubled(data.astype(jnp.uint32), nn, 0)
    b0 = data.astype(jnp.uint32)
    bs = [b0] + [_wrap_slice(d2, j % nn, cap) for j in range(1, 8)]
    key4a = (bs[0] << 24) | (bs[1] << 16) | (bs[2] << 8) | bs[3]
    key4b = (bs[4] << 24) | (bs[5] << 16) | (bs[6] << 8) | bs[7]
    prim = jnp.where(real, 0, 1)
    seca = jnp.where(real, key4a, idx.astype(jnp.uint32))
    secb = jnp.where(real, key4b, 0)
    # (idx, run) packed into one payload operand (run in bit 30; see
    # rotsort._refine_ranks)
    pidx = idx | (run << 30)
    p_s, ka_s, kb_s, p0 = jax.lax.sort(
        (prim, seca, secb, pidx), num_keys=3, is_stable=True
    )
    order0 = p0 & ((1 << 30) - 1)
    run0 = p0 >> 30
    diff0 = (p_s[1:] != p_s[:-1]) | (ka_s[1:] != ka_s[:-1]) \
        | (kb_s[1:] != kb_s[:-1])
    grp0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), diff0.astype(jnp.int32)]
    )
    rank0 = _scatter_perm(order0, jnp.cumsum(grp0))
    done0 = ~jnp.any(_tied_rows(diff0) & (run0 == 0))

    def cond(state):
        _, k, done = state
        return (k < n) & ~done

    def body(state):
        rank, k, _ = state
        r2 = _doubled(rank, nn, jnp.int32(-1))
        keys = [rank] + [
            _wrap_slice(r2, (j * k) % nn, cap) for j in range(1, _FAN)
        ]
        out = jax.lax.sort((*keys, pidx), num_keys=_FAN, is_stable=True)
        order = out[_FAN] & ((1 << 30) - 1)
        diff = out[0][1:] != out[0][:-1]
        for r in out[1:_FAN]:
            diff = diff | (r[1:] != r[:-1])
        newgrp = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), diff.astype(jnp.int32)]
        )
        rank = _scatter_perm(order, jnp.cumsum(newgrp))
        done = ~jnp.any(_tied_rows(diff) & ((out[_FAN] >> 30) == 0))
        return rank, k * _FAN, done

    rank, _, done = jax.lax.while_loop(
        cond, body, (rank0, jnp.int32(8), done0)
    )
    return rank, done


def _final_order(data, rank, idx, n, tie_desc: bool):
    """Tie-broken final sort -> (order, last, idx0, rank_final).

    Pad rows keep rank >= every real rank, so real rotations occupy the
    first n sorted rows.  `last[i] = data[(order[i]-1) mod n]` rides the
    sort as a payload built from one wrap slice of the doubled data.
    """
    cap = data.shape[0]
    nn = jnp.maximum(n, 1)
    real = idx < n
    d2 = _doubled(data, nn, jnp.uint8(0))
    prev = _wrap_slice(d2, (nn - 1) % nn, cap)  # prev[i]=data[(i-1)%n]
    if tie_desc:
        tie = jnp.where(real, (n - 1) - idx, idx)
        _, tk, last = jax.lax.sort((rank, tie, prev), num_keys=2,
                                   is_stable=True)
        order = jnp.where(jnp.arange(cap) < n, (n - 1) - tk, tk)
        # order reconstructed; rank_final via scatter of the real order
        rank_final = _scatter_perm(order, idx)
    else:
        _, order, last = jax.lax.sort((rank, idx, prev), num_keys=1,
                                      is_stable=True)
        rank_final = _scatter_perm(order, idx)
    mask = jnp.arange(cap) < n
    last = jnp.where(mask, last, 0).astype(jnp.uint8)
    idx0 = jnp.argmax((order == 0) & mask).astype(jnp.int32)
    return order, last, idx0, rank_final


@partial(jax.jit, static_argnames=("tie_desc",))
def bwt_encode_masked(data: jax.Array, n: jax.Array, tie_desc: bool = False):
    """BWT of the first n bytes of uint8[cap] -> (last uint8[cap] valid
    prefix n, idx0 int32)."""
    cap = data.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    rank, _ = _refine_ranks_masked(data, idx, n,
                                   benign_ties=not tie_desc)
    _, last, idx0, _ = _final_order(data, rank, idx, n, tie_desc)
    return last, idx0


@partial(jax.jit, static_argnames=("anchor_stride",))
def bwt_encode_masked_anchored(data: jax.Array, n: jax.Array,
                               anchor_stride: int = ANCHOR_STRIDE):
    """Masked BWT + decode-restart anchors.

    Returns (last uint8[cap], idx0, anchors int32[R], ok bool) with
    R = ceil(cap/stride) rows; rows past ceil(n/stride) repeat idx0.
    """
    cap = data.shape[0]
    S = anchor_stride
    R = -(-cap // S)
    idx = jnp.arange(cap, dtype=jnp.int32)
    nn = jnp.maximum(n, 1)
    rank, ok = _refine_ranks_masked(data, idx, n)
    _, last, idx0, rank_final = _final_order(data, rank, idx, n, False)
    j = jnp.arange(R, dtype=jnp.int32)
    pos = (nn - j * S) % nn
    used = j * S < n
    anchors = jnp.where(used, rank_final[pos], idx0)
    return last, idx0, anchors, ok


@jax.jit
def _lf_map(last: jax.Array, n: jax.Array):
    """LF successor map over the valid prefix (pad rows self-loop)."""
    cap = last.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    sym = jnp.where(real, last.astype(jnp.int32), 256 + idx)
    _, order = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    T = _scatter_perm(order, idx)
    return jnp.where(real, T, idx)


@partial(jax.jit, static_argnames=("anchor_stride",))
def bwt_decode_masked_anchored(last: jax.Array, n: jax.Array,
                               idx0: jax.Array, anchors: jax.Array,
                               anchor_stride: int = ANCHOR_STRIDE):
    """Anchored masked inverse BWT -> uint8[cap] (valid prefix n).

    Lane j runs S serial LF steps from anchors[j]; lane j's steps are
    output positions [n-1-j*S, n-1-(j+1)*S) walked backwards, so the
    step-major matrix flattens to the output via one flip and one
    traced-offset slice.
    """
    cap = last.shape[0]
    S = anchor_stride
    R = anchors.shape[0]
    T = _lf_map(last, n)
    del idx0  # anchors[0] == idx0 by construction

    out0 = jnp.zeros((S, R), jnp.uint8)
    TL = jnp.stack([T, last.astype(jnp.int32)], axis=1)  # [cap, 2]

    def body(t, st):
        p, out = st
        e = TL[p]                                 # [R, 2] one gather
        row = e[:, 1].astype(jnp.uint8)[None, :]
        out = jax.lax.dynamic_update_slice(out, row, (t, 0))
        return e[:, 0], out

    _, out = jax.lax.fori_loop(0, S, body, (anchors, out0), unroll=4)
    flat = out.T.reshape(-1)                      # lane-major steps
    # result[j] = flat[n-1-j]: flip then slice at traced offset.  Pad
    # first — dynamic_slice CLAMPS starts near the end, which would
    # silently rotate the output for n close to R*S.
    flipped = jnp.concatenate([flat[::-1], jnp.zeros((cap,), flat.dtype)])
    start = R * S - n
    return jax.lax.dynamic_slice(flipped, (start,), (cap,))


@jax.jit
def bwt_decode_masked(last: jax.Array, n: jax.Array, idx0: jax.Array):
    """Inverse BWT of the first n bytes of uint8[cap] -> uint8[cap].

    Metadata-free pointer-doubling fallback (log2(cap) full-size gather
    rounds — use the anchored variant on the hot path)."""
    cap = last.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    T = _lf_map(last, n)

    rounds = max(1, (cap - 1).bit_length())
    state0 = jnp.stack([T, jnp.ones((cap,), jnp.int32)], axis=1)

    def round_body(_, state):
        ptr = state[:, 0]
        tgt = state[ptr]
        live = (ptr != idx0)[:, None] & real[:, None]
        upd = jnp.stack([tgt[:, 0], state[:, 1] + tgt[:, 1]], axis=1)
        return jnp.where(live, upd, state)

    state = jax.lax.fori_loop(0, rounds, round_body, state0)
    ptr, d = state[:, 0], state[:, 1]
    in_cycle = (ptr == idx0) & real
    p = jnp.maximum(d[idx0], 1)
    slot = jnp.where(in_cycle, (p - d) % p, cap)
    cyc = jnp.zeros((cap,), jnp.uint8).at[slot].set(last, mode="drop")
    j = jnp.arange(cap, dtype=jnp.int32)
    return cyc[(n - 1 - j) % p]


@jax.jit
def forward_masked(block: jax.Array, n: jax.Array):
    """BWT -> MTF -> RLE2 over the valid prefix; single compiled program.

    Returns (syms int32[cap], m, idx0, hist int32[257]).
    """
    from tpulc.codecs.bwt.rle import ALPHABET

    cap = block.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    last, idx0 = bwt_encode_masked(block, n)
    ranks = mtf_encode(last)
    # force pad ranks nonzero so a trailing real zero-run closes, and
    # pad maps 1:1 to literals for the count trim
    ranks = jnp.where(idx < n, ranks, jnp.uint8(255))
    syms, m_all = rle2_encode(ranks)
    m = m_all - (cap - n)
    masked = jnp.where(idx < m, syms, ALPHABET)
    s_sorted = jax.lax.sort((masked,), num_keys=1)[0]
    edges = jnp.searchsorted(
        s_sorted, jnp.arange(ALPHABET + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    hist = jnp.diff(edges)
    return syms, m, idx0, hist


@partial(jax.jit, static_argnames=("anchor_stride",))
def forward_masked_anchored(block: jax.Array, n: jax.Array,
                            anchor_stride: int = ANCHOR_STRIDE):
    """`forward_masked` + decode anchors: returns
    (syms, m, idx0, hist, anchors int32[R], ok bool)."""
    from tpulc.codecs.bwt.rle import ALPHABET

    cap = block.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    last, idx0, anchors, ok = bwt_encode_masked_anchored(
        block, n, anchor_stride
    )
    ranks = mtf_encode(last)
    ranks = jnp.where(idx < n, ranks, jnp.uint8(255))
    syms, m_all = rle2_encode(ranks)
    m = m_all - (cap - n)
    masked = jnp.where(idx < m, syms, ALPHABET)
    s_sorted = jax.lax.sort((masked,), num_keys=1)[0]
    edges = jnp.searchsorted(
        s_sorted, jnp.arange(ALPHABET + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    hist = jnp.diff(edges)
    return syms, m, idx0, hist, anchors, ok


@jax.jit
def inverse_masked(syms: jax.Array, m: jax.Array, n: jax.Array,
                   idx0: jax.Array):
    """RLE2 -> MTF -> BWT inverse over the valid prefix -> uint8[cap]."""
    ranks, _ = rle2_decode(syms, m)
    last = mtf_decode(ranks)
    return bwt_decode_masked(last, n, idx0)


@partial(jax.jit, static_argnames=("anchor_stride",))
def inverse_masked_anchored(syms: jax.Array, m: jax.Array, n: jax.Array,
                            idx0: jax.Array, anchors: jax.Array,
                            anchor_stride: int = ANCHOR_STRIDE):
    """Anchored inverse pipeline (RLE2 -> MTF -> anchored IBWT)."""
    ranks, _ = rle2_decode(syms, m)
    last = mtf_decode(ranks)
    return bwt_decode_masked_anchored(last, n, idx0, anchors,
                                      anchor_stride)


@partial(jax.jit, static_argnames=("anchor_stride",))
def forward_ranks_anchored(block: jax.Array, n: jax.Array,
                           anchor_stride: int = ANCHOR_STRIDE):
    """BWT + MTF WITHOUT the RLE2 stage: the group-rank coder
    (`bsclike/grc.py`) codes (rank, run) groups directly from the MTF
    stream (libbsc's QLFC decomposition, `qlfc.cpp:448-752`).
    Returns (ranks int32[cap] — 0 past n, idx0, anchors, ok)."""
    cap = block.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    last, idx0, anchors, ok = bwt_encode_masked_anchored(
        block, n, anchor_stride
    )
    ranks = mtf_encode(last).astype(jnp.int32)
    ranks = jnp.where(idx < n, ranks, 0)
    return ranks, idx0, anchors, ok


@partial(jax.jit, static_argnames=("anchor_stride",))
def inverse_ranks_anchored(ranks: jax.Array, n: jax.Array,
                           idx0: jax.Array, anchors: jax.Array,
                           anchor_stride: int = ANCHOR_STRIDE):
    """Anchored inverse from the MTF rank stream (no RLE2)."""
    last = mtf_decode(ranks.astype(jnp.uint8))
    return bwt_decode_masked_anchored(last, n, idx0, anchors,
                                      anchor_stride)
