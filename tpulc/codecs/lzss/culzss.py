"""CULZSS packet-format LZSS codec (cuda-lzss-cluster wire format).

Format ground truth is the reference decoder (`gpu_decompress.cu:120-244`):
each 4096-byte packet is independent, with its own 128-byte ring window
initialized to spaces; the byte stream per packet is a flag byte per 8
tokens (LSB-first, bit set = literal), literal = 1 byte, match =
(length, offset) bytes copying from the pre-token window snapshot.
Packets whose packed form reaches PCKTSIZE are stored raw (the
reference's "compression took more" fallback, `gpu_compress.cu:496`,
`culzss.c:176-183`).

Design: every packet is a vmapped lane — encode runs the same
chain-search + pointer-doubling greedy parse as the Dipperstein codec
(packet-local), plus an analytic same-byte run rule that recovers the
long-match case (runs) without deep match extension.  Byte-exact layout
is produced by scatters at prefix-summed byte offsets.  Decode walks
tokens serially per packet (the reference's unit of parallelism) across
all packet lanes at once, then resolves copy sources byte-parallel by
pointer doubling.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from tpulc.primitives.parallel import orbit_flags

PCKT = 4096
WIN = 128
MAX_LEN = 127          # length byte; reference clamps to MAX_CODED-1
MIN_MATCH = 3
_PAD = WIN + PCKT + MAX_LEN + 8


def _encode_packet(packet: jax.Array):
    """uint8[PCKT] -> (bytes uint8[PCKT+PCKT//8+8], nbytes, ntokens).

    Match search covers the FULL 128-byte window at every position (the
    reference's own brute scan, `gpu_compress.cu:104-180`), not a hash
    chain: for each distance d in 1..WIN build the equality row
    eq[d,i] = x[i]==x[i-d], then turn rows into run lengths ("common
    prefix starting at i") with 7 capped doubling steps.  Snapshot
    window semantics (`gpu_decompress.cu:120` reads the pre-token ring)
    cap a usable match at its own distance, which also makes same-byte
    runs fall out of the generic search.
    """
    padded = jnp.concatenate(
        [jnp.full((WIN,), 32, jnp.uint8), packet,
         jnp.zeros((_PAD - WIN - PCKT,), jnp.uint8)]
    )
    n_total = _PAD
    pos = jnp.arange(PCKT, dtype=jnp.int32) + WIN

    # eq[d-1, i] = padded[i] == padded[i-d]  (False where i < d)
    eq = jnp.stack([
        jnp.concatenate([jnp.zeros((d,), bool),
                         padded[d:] == padded[:n_total - d]])
        for d in range(1, WIN + 1)
    ])
    # run length of True starting at i: L_k = min(true_run, 2^k).
    # Five steps reach min(run, 32) >= MAX_LEN=18 — all the search
    # needs — in int8 (the r5 trace showed this doubling dominating
    # encode: 7 int16 steps moved ~2.8x the bytes these 5 int8 do).
    L = eq.astype(jnp.int8)
    s = 1
    for _ in range(5):
        Ls = jnp.concatenate(
            [L[:, s:], jnp.zeros((WIN, s), jnp.int8)], axis=1)
        L = L + jnp.where(L == s, Ls, 0)
        s *= 2
    Lp = L[:, WIN:WIN + PCKT].astype(jnp.int32)
    dcol = jnp.arange(1, WIN + 1, dtype=jnp.int32)[:, None]
    Lc = jnp.minimum(Lp, jnp.minimum(dcol, MAX_LEN))
    best_len = jnp.max(Lc, axis=0)
    best_d = jnp.argmax(Lc, axis=0).astype(jnp.int32) + 1  # ties -> nearest
    best_src = pos - best_d

    # clamp to packet remainder
    best_len = jnp.minimum(best_len, PCKT - (pos - WIN))
    is_match = best_len >= MIN_MATCH
    step = jnp.where(is_match, best_len, 1)

    # greedy parse (orbit of 0, gather-only path doubling)
    jump = jnp.minimum(jnp.arange(PCKT, dtype=jnp.int32) + step, PCKT)
    jump_e = jnp.concatenate([jump, jnp.full((1,), PCKT, jnp.int32)])
    is_start = orbit_flags(jump_e, PCKT, PCKT)

    # byte layout
    tok_bytes = jnp.where(is_start, jnp.where(is_match, 2, 1), 0)
    tok_idx = jnp.cumsum(is_start.astype(jnp.int32)) - is_start
    group = tok_idx >> 3
    data_off = jnp.cumsum(tok_bytes) - tok_bytes
    byte_off = data_off + group + 1  # +1 flag byte of own group, + earlier
    ntokens = jnp.sum(is_start.astype(jnp.int32))
    ngroups = (ntokens + 7) >> 3
    total_bytes = (
        jnp.sum(tok_bytes) + ngroups
    )

    cap_out = PCKT + PCKT // 8 + 8
    out = jnp.zeros((cap_out,), jnp.uint8)
    # token payload bytes
    lit_tgt = jnp.where(is_start & ~is_match, byte_off, cap_out)
    out = out.at[lit_tgt].set(packet, mode="drop")
    m_tgt = jnp.where(is_start & is_match, byte_off, cap_out)
    out = out.at[m_tgt].set(best_len.astype(jnp.uint8), mode="drop")
    m_tgt2 = jnp.where(is_start & is_match, byte_off + 1, cap_out)
    out = out.at[m_tgt2].set((best_src % WIN).astype(jnp.uint8), mode="drop")
    # flag bytes: group g's flag byte sits right before its first
    # token's payload.  first token of group g has tok_idx == 8g.
    first_of_group = is_start & ((tok_idx & 7) == 0)
    flag_pos_tgt = jnp.where(first_of_group, byte_off - 1, cap_out)
    flag_bit = jnp.where(
        is_start & ~is_match,
        jnp.left_shift(jnp.int32(1), (tok_idx & 7)),
        0,
    )
    flags_by_group = jnp.zeros((PCKT // 8 + 2,), jnp.int32).at[
        jnp.where(is_start, group, PCKT // 8 + 1)
    ].add(flag_bit, mode="drop")
    out = out.at[flag_pos_tgt].set(
        flags_by_group[group].astype(jnp.uint8), mode="drop"
    )
    return out, total_bytes, ntokens


@jax.jit
def culzss_encode_block(block: jax.Array):
    """uint8[N] (N multiple of PCKT) -> per-packet byte arrays + sizes."""
    P = block.shape[0] // PCKT
    packets = block.reshape(P, PCKT)
    return jax.vmap(_encode_packet)(packets)


def _decode_packet_records(pbytes, psize):
    """Parallel token extraction of one packet: scatter (code, start)
    records at output byte positions.

    The reference decoder walks tokens serially (`gpu_decompress.cu:169`
    one thread per packet).  Here the walk is parallel: a flag byte's
    VALUE alone determines its group's byte span (1 flag + 8 tokens of
    1 or 2 bytes = 17 - popcount(flags)), so group starts are the orbit
    of 0 under a static jump table — log2 pointer-doubling rounds — and
    every token of every group then extracts simultaneously.

    Returns (rec int32[PCKT+1] packed (is_lit<<16 | b1<<8 | b0), start
    flags, out_len).
    """
    cap = PCKT + 1
    capb = pbytes.shape[0]
    idx = jnp.arange(capb, dtype=jnp.int32)
    f = pbytes.astype(jnp.int32)
    ones = jax.lax.population_count(f.astype(jnp.uint8)).astype(jnp.int32)
    # group-start chain (positions >= psize are dead ends); groups span
    # at least 9 bytes, so the orbit has at most capb//9 + 1 entries
    jump = jnp.minimum(jnp.where(idx < psize, idx + 17 - ones, capb), capb)
    jump_e = jnp.concatenate([jump, jnp.full((1,), capb, jnp.int32)])
    is_grp = orbit_flags(jump_e, capb, capb // 9 + 2) & (idx < psize)

    # COMPACT the group starts before extracting tokens: scatter/gather
    # cost is per source element, and only ~1/9 of byte positions start
    # a group — working on the compact [G, 8] grid instead of
    # [capb, 8] cuts the record scatters and b0/b1 gathers ~9x.
    G = capb // 9 + 2
    key = jnp.where(is_grp, idx, capb + idx)
    gpos = jax.lax.sort(key)[:G]                 # group starts, in order
    g_ok = gpos < capb
    gposc = jnp.minimum(gpos, capb - 1)
    fg = pbytes[gposc].astype(jnp.int32)
    fk = jnp.stack([(fg >> k) & 1 for k in range(8)], axis=1)  # [G, 8]
    sz = 2 - fk
    off_excl = jnp.cumsum(sz, axis=1) - sz                    # excl prefix
    t = gposc[:, None] + 1 + off_excl                         # token starts
    exists = g_ok[:, None] & (t + sz <= psize)
    tc = jnp.minimum(t, capb - 2)
    b0 = pbytes[tc].astype(jnp.int32)
    b1 = pbytes[tc + 1].astype(jnp.int32)
    out_b = jnp.where(exists, jnp.where(fk == 1, 1, b0), 0)

    # output byte position of each token: group-level exclusive cumsum
    # of per-group output + within-group exclusive prefix
    grp_out = jnp.sum(out_b, axis=1)
    grp_pre = jnp.cumsum(grp_out) - grp_out
    outpos = grp_pre[:, None] + (jnp.cumsum(out_b, axis=1) - out_b)

    code = (fk << 16) | (b1 << 8) | b0
    tgt = jnp.where(exists, jnp.minimum(outpos, PCKT), cap)
    rec = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(code, mode="drop")
    start = jnp.zeros((cap + 1,), jnp.int32).at[tgt].set(1, mode="drop")
    return rec[:cap], start[:cap], jnp.sum(out_b)


@jax.jit
def culzss_decode_block(pbuf: jax.Array, psizes: jax.Array):
    """pbuf uint8[P, cap], psizes int32[P] -> uint8[P, PCKT] decoded."""
    rec, start, outl = jax.vmap(_decode_packet_records)(pbuf, psizes)
    # byte-level resolution per packet (batched elementwise + gathers)
    P = pbuf.shape[0]
    idx = jnp.arange(PCKT, dtype=jnp.int32)[None, :]
    starts = start[:, :PCKT] > 0
    tok_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(starts, idx, -1), axis=1
    )
    tok_start_c = jnp.maximum(tok_start, 0)
    code = jnp.take_along_axis(rec[:, :PCKT], tok_start_c, axis=1)
    is_lit = (code >> 16) & 1
    b0 = code & 0xFF
    off = (code >> 8) & 0xFF
    j = idx - tok_start_c
    w = (off + j) % WIN
    p_pad = tok_start_c + WIN
    q = p_pad - 1 - ((p_pad - 1 - w) % WIN)

    total = PCKT + WIN
    pidx = jnp.broadcast_to(jnp.arange(total, dtype=jnp.int32)[None, :],
                            (P, total))
    valid = idx < outl[:, None]
    lit_mask = (is_lit == 1) & valid
    # literal values land at their OWN positions — an identity scatter
    # is just a masked select (the scatter form cost ~0.3 s/corpus)
    val = jnp.concatenate(
        [jnp.full((P, WIN), 32, jnp.uint8),
         jnp.where(lit_mask, b0.astype(jnp.uint8), jnp.uint8(32))],
        axis=1)
    src = jnp.where((is_lit == 0) & valid, q, idx + WIN)
    src_full = jnp.concatenate([pidx[:, :WIN], src], axis=1)
    root = jnp.concatenate(
        [jnp.ones((P, WIN), bool), lit_mask | ~valid], axis=1
    )
    src_full = jnp.where(root, pidx, src_full)

    # pointer doubling to fixpoint: worst case ceil(log2(PCKT+WIN))=13
    # rounds, but real chains resolve in a handful — each gather round
    # costs ~4M elements, so the convergence check pays for itself.
    def db_cond(st):
        i, src, done = st
        return (i < 13) & ~done

    def db_step(st):
        i, src, _ = st
        nxt = jnp.take_along_axis(src, src, axis=1)
        return i + 1, nxt, jnp.all(nxt == src)

    _, src_full, _ = jax.lax.while_loop(
        db_cond, db_step, (jnp.int32(0), src_full, jnp.bool_(False)))
    out = jnp.take_along_axis(val, src_full, axis=1)[:, WIN:]
    return out, outl
