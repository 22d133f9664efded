"""bzip2-style zero-run coding (RUNA/RUNB) as data-parallel scans.

bzip2's `generateMTFValues` (`cuda-bzip2-ipdpsw/compress.c:123-240`)
replaces runs of MTF-rank zeros with bijective base-2 digits RUNA/RUNB
serially.  Both directions are scans here:

encode: zero-run starts/lengths via max/min scans; a run of L zeros
  emits k = floor(log2(L+1)) digits, digit i = bit i of (L+1) (LSB
  first, 0->RUNA, 1->RUNB); output placement via exclusive cumsum of
  per-position emission counts + k bounded scatter passes.

decode: run-group membership via scans; L = segment-sum of
  (digit+1)<<i recovers the zero count; literals scatter at cumsum
  offsets into a zero-initialized output, so zero expansion is free.

Alphabet: 0 = RUNA, 1 = RUNB, nonzero MTF rank r -> symbol r+1
(2..256); 257-symbol Huffman alphabet, no explicit EOB (the container
stores symbol counts instead of bzip2's EOB sentinel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

RUNA = 0
RUNB = 1
ALPHABET = 257  # 2 run symbols + ranks 1..255 shifted to 2..256


@jax.jit
def rle2_encode(ranks: jax.Array):
    """uint8[n] MTF ranks -> (symbols int32[n], m int32 valid count).

    Output never exceeds input length (k digits <= L zeros; literals 1:1).
    """
    n = ranks.shape[0]
    r = ranks.astype(jnp.int32)
    i = jnp.arange(n, dtype=jnp.int32)
    z = r == 0

    # Start of each zero run, and its length.
    prev_nz = jax.lax.associative_scan(jnp.maximum, jnp.where(z, -1, i))
    is_run_start = z & (i == prev_nz + 1)
    # next nonzero at/after each position (reverse min-scan)
    next_nz = jax.lax.associative_scan(
        jnp.minimum, jnp.where(z, n, i), reverse=True
    )
    L = jnp.where(is_run_start, next_nz - i, 0)  # zeros in the run

    # digits per run: k = floor(log2(L+1));  emission count per position
    M = L + 1
    k = jnp.where(is_run_start, jnp.int32(31) - jnp.int32(jax.lax.clz(M.astype(jnp.uint32)).astype(jnp.int32)), 0)
    emit = jnp.where(z, jnp.where(is_run_start, k, 0), 1)
    off = jnp.cumsum(emit) - emit
    m = off[-1] + emit[-1] if n else jnp.int32(0)

    # Scatter one record per token (literal or run start), then derive
    # run digits elementwise: output slot t of a run starting at output
    # offset o carries bit (t - o) of M.  One scatter + one
    # "latest record" scan replace per-digit scatter passes and the
    # record gather.
    tok = ~z | is_run_start
    tok_tgt = jnp.where(tok, off, n)
    # record: run start -> M | RUNBIT, literal -> r+1 (one packed int);
    # every record is > 0, so zero marks "no token at this slot".
    RUNBIT = jnp.int32(1 << 30)
    rec = jnp.where(z, M | RUNBIT, r + 1)
    rec_at = jnp.zeros((n + 1,), jnp.int32).at[tok_tgt].set(rec, mode="drop")
    oidx = jnp.arange(n, dtype=jnp.int32)

    def latest(a, b):
        p1, v1 = a
        p2, v2 = b
        take2 = p2 >= 0
        return jnp.where(take2, p2, p1), jnp.where(take2, v2, v1)

    owner, o_rec = jax.lax.associative_scan(
        latest, (jnp.where(rec_at[:n] > 0, oidx, -1), rec_at[:n])
    )
    owner = jnp.maximum(owner, 0)
    is_run_slot = (o_rec & RUNBIT) != 0
    digit = (o_rec >> jnp.clip(oidx - owner, 0, 29)) & 1
    out = jnp.where(is_run_slot, digit, o_rec)
    out = jnp.where(oidx < m, out, 0)
    return out, m


@jax.jit
def rle2_decode(symbols: jax.Array, m: jax.Array):
    """int32[cap] symbols (valid prefix m) -> (ranks uint8[cap], n int32).

    cap bounds the decoded length (a valid stream never expands past the
    encoder's input length, which the container records).
    """
    cap = symbols.shape[0]
    i = jnp.arange(cap, dtype=jnp.int32)
    valid = i < m
    s = jnp.where(valid, symbols, 2)  # pad as literals (ignored via valid)
    isrun = valid & (s <= 1)

    # group start = run symbol whose predecessor is not a run symbol
    prev_lit = jax.lax.associative_scan(
        jnp.maximum, jnp.where(isrun, -1, i)
    )
    gstart = prev_lit + 1          # start index of my run group (if isrun)
    pos_in_group = i - gstart      # digit index (LSB first)
    contrib = jnp.where(isrun, (s + 1) << jnp.clip(pos_in_group, 0, 30), 0)
    # Zeros emitted by each group, summed at the group-start position:
    # a reverse SEGMENTED sum-scan with literal positions as segment
    # resets puts each group's digit total on every member, in
    # particular its start (a scan in place of a scatter-add).
    rv = contrib[::-1]
    rf = (~isrun)[::-1]

    def segsum(a, b):
        v1, f1 = a
        v2, f2 = b
        return jnp.where(f2, v2, v1 + v2), f1 | f2

    seg, _ = jax.lax.associative_scan(segsum, (rv, rf))
    L_at_start = seg[::-1]

    is_gstart = isrun & (pos_in_group == 0)
    out_len = jnp.where(
        valid & is_gstart, L_at_start, jnp.where(valid & ~isrun, 1, 0)
    )
    off = jnp.cumsum(out_len) - out_len
    n = off[-1] + out_len[-1] if cap else jnp.int32(0)

    out = jnp.zeros((cap,), jnp.uint8)
    lit = valid & (s >= 2)
    tgt = jnp.where(lit, off, cap)
    out = out.at[tgt].set((s - 1).astype(jnp.uint8), mode="drop")
    return out, n


def rle2_encode_np(ranks):
    """Serial gold mirroring bzip2's RUNA/RUNB emission."""
    import numpy as np

    out = []
    run = 0

    def flush(run):
        while run > 0:
            if run & 1:
                out.append(RUNA)
                run = (run - 1) // 2
            else:
                out.append(RUNB)
                run = (run - 2) // 2

    for v in np.asarray(ranks):
        if v == 0:
            run += 1
        else:
            flush(run)
            run = 0
            out.append(int(v) + 1)
    flush(run)
    return np.array(out, np.int32)
