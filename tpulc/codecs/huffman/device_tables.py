"""On-device canonical Huffman table construction.

The host builds optimal code *lengths* (package-merge,
`tables.py`, mirroring cuhd `llhuffman_encoder.cc:18`); everything
derivable from lengths — canonical codes and the flat 2^L decode LUT
(`llhuffman_encoder.cc:160,240`) — can be rebuilt on device from the
257-byte lengths vector: shipping the 2^15-entry LUT would cost 128 KB
per block over PCIe, the lengths cost 257 bytes, and the device
rebuild is a few vector ops.

The construction matches `tables.canonical_codes` exactly: codes
assigned shorter-first, ties by symbol index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_len",))
def canonical_lut_packed(lengths: jax.Array, max_len: int) -> jax.Array:
    """lengths int32[S] -> packed decode LUT int32[2^L]: (sym << 4) | len.

    Windows not covered by any codeword (possible only for degenerate /
    corrupt length sets) get entry 0, which decoders treat as a 1-bit
    skip.
    """
    S = lengths.shape[0]
    L = max_len
    lens = jnp.clip(lengths.astype(jnp.int32), 0, L)

    # counts per code length (tiny scatter-add over <= 16 bins)
    cnt = jnp.zeros((L + 1,), jnp.int32).at[lens].add(
        jnp.where(lens > 0, 1, 0)
    )
    # first canonical code per length: fc[l] = (fc[l-1] + cnt[l-1]) << 1
    fc = [jnp.int32(0)] * (L + 1)
    for l in range(1, L + 1):
        fc[l] = (fc[l - 1] + cnt[l - 1]) << 1
    # symbols with length < l (rank base into the sorted-symbol list)
    cum = [jnp.int32(0)] * (L + 1)
    for l in range(1, L + 1):
        cum[l] = cum[l - 1] + cnt[l - 1]

    # symbols sorted by (length, symbol); zero-length symbols last
    syms = jnp.arange(S, dtype=jnp.int32)
    sort_key = jnp.where(lens > 0, lens, L + 1) * (2 * S) + syms
    _, syms_sorted = jax.lax.sort((sort_key, syms), num_keys=1)

    # per-window codeword length: window w matches length l iff its
    # l-bit prefix falls in [fc[l], fc[l] + cnt[l])
    w = jnp.arange(1 << L, dtype=jnp.int32)
    lval = jnp.zeros((1 << L,), jnp.int32)
    for l in range(1, L + 1):
        pref = w >> (L - l)
        hit = (pref >= fc[l]) & (pref < fc[l] + cnt[l])
        lval = jnp.where((lval == 0) & hit, l, lval)

    # rank of the matched codeword inside the sorted-symbol list
    fcv = jnp.zeros_like(w)
    cumv = jnp.zeros_like(w)
    shv = jnp.zeros_like(w)
    for l in range(1, L + 1):
        m = lval == l
        fcv = jnp.where(m, fc[l], fcv)
        cumv = jnp.where(m, cum[l], cumv)
        shv = jnp.where(m, L - l, shv)
    j = cumv + (w >> shv) - fcv
    sym = syms_sorted[jnp.clip(j, 0, S - 1)]
    return jnp.where(lval > 0, (sym << 4) | lval, 0)


@partial(jax.jit, static_argnames=("max_len",))
def canonical_decode_params(lengths: jax.Array, max_len: int):
    """lengths int32[S] -> (lim int32[L+1], baseoff int32[L+1],
    syms_sorted int32[S]) for LUT-free canonical decode.

    A window's codeword length is the smallest l with
    ``(win >> (L-l)) < lim[l]`` (classic canonical first-match), and its
    canonical index is ``baseoff[l] + (win >> (L-l))``; the symbol is
    ``syms_sorted[index]``.  This is the decode form the Pallas kernel
    uses: 16 scalars + a 257-entry map instead of a 2^L LUT gather.
    """
    S = lengths.shape[0]
    L = max_len
    lens = jnp.clip(lengths.astype(jnp.int32), 0, L)
    cnt = jnp.zeros((L + 1,), jnp.int32).at[lens].add(
        jnp.where(lens > 0, 1, 0)
    )
    fc = [jnp.int32(0)] * (L + 1)
    cum = [jnp.int32(0)] * (L + 1)
    for l in range(1, L + 1):
        fc[l] = (fc[l - 1] + cnt[l - 1]) << 1
        cum[l] = cum[l - 1] + cnt[l - 1]
    lim = jnp.stack(
        [jnp.int32(0)] + [fc[l] + cnt[l] for l in range(1, L + 1)]
    )
    baseoff = jnp.stack(
        [jnp.int32(0)] + [cum[l] - fc[l] for l in range(1, L + 1)]
    )
    syms = jnp.arange(S, dtype=jnp.int32)
    sort_key = jnp.where(lens > 0, lens, L + 1) * (2 * S) + syms
    _, syms_sorted = jax.lax.sort((sort_key, syms), num_keys=1)
    return lim, baseoff, syms_sorted


# Pad weight: strictly above any real package weight.  A package holds
# each symbol at most max_len times, so real weights stay <= L * total
# <= 15 * 2^25 < 2^30 for blocks up to 32 MB of uint8 counts; the
# uint32 saturating add below never wraps (2 * 2^30 < 2^32).
# (A Python int, NOT a jnp scalar: a module-level jax.Array would be a
# captured device constant that jit lifts to a hidden executable
# argument, which breaks the C++ fastpath under multi-device CPU.)
_PM_INF = 1 << 30


@partial(jax.jit, static_argnames=("max_len",))
def package_merge_lengths_device(freqs: jax.Array, max_len: int):
    """Device package-merge: freqs int32[S] -> optimal length-limited
    code lengths int32[S].  Bit-identical to `tables.package_merge_lengths`
    whenever ``sum(freqs) <= 2^25`` (always true for block histograms:
    the sum IS the block size, and blocks top out at 25 MB).

    Items are (weight, per-symbol count row); packaging is a row-add
    and list merging a stable sort — the whole build is L rounds of
    [2S]-sorts plus one [1,2S]x[2S,S] contraction for the final
    count, which is what lets the bz compress path run as ONE device
    program per block (the reference's `compress_app.cu:507-526` shape)
    instead of bouncing histograms to the host for table build.

    Fixed-shape padding: absent symbols and empty list slots carry
    saturating INF weights, so they stably sort after every real item
    and their zero count rows never pollute the take window (a real
    item orphaned by odd-length pairing merges with a pad into an
    INF-weight package — same effect as the host's drop).
    """
    S = freqs.shape[0]
    f = freqs.astype(jnp.uint32)
    present = f > 0
    n = jnp.sum(present.astype(jnp.int32))

    syms = jnp.arange(S, dtype=jnp.int32)
    coin_w = jnp.where(present, f, _PM_INF)
    # coins sorted by weight, ties by symbol index (host's stable sort)
    coin_w_s, coin_sym = jax.lax.sort((coin_w, syms), num_keys=1,
                                      is_stable=True)
    coin_c = jax.nn.one_hot(coin_sym, S, dtype=jnp.int32) * \
        (coin_w_s < _PM_INF).astype(jnp.int32)[:, None]

    prev_w = jnp.full((S,), _PM_INF, jnp.uint32)
    prev_c = jnp.zeros((S, S), jnp.int32)
    idx2 = jnp.arange(2 * S, dtype=jnp.int32)
    all_w, all_c = None, None
    for _ in range(max_len):
        cat_w = jnp.concatenate([coin_w_s, prev_w])
        cat_c = jnp.concatenate([coin_c, prev_c])
        all_w, order = jax.lax.sort((cat_w, idx2), num_keys=1,
                                    is_stable=True)
        all_c = cat_c[order]
        pw = jnp.minimum(all_w[0::2] + all_w[1::2], _PM_INF)
        pc = all_c[0::2] + all_c[1::2]
        prev_w, prev_c = pw, pc
    take = 2 * n - 2
    sel = (idx2 < take).astype(jnp.int32)
    lens = jnp.matmul(
        sel[None, :].astype(jnp.float32),
        all_c.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )[0].astype(jnp.int32)
    # host semantics: a single present symbol gets length 1
    lens = jnp.where(n == 1, present.astype(jnp.int32), lens)
    return lens


@partial(jax.jit, static_argnames=("max_len",))
def canonical_codes_device(lengths: jax.Array, max_len: int):
    """lengths int32[S] -> (codes uint32[S], lengths int32[S]).

    Same assignment as `tables.canonical_codes`: within a length, codes
    increase with symbol index.
    """
    S = lengths.shape[0]
    L = max_len
    lens = jnp.clip(lengths.astype(jnp.int32), 0, L)
    cnt = jnp.zeros((L + 1,), jnp.int32).at[lens].add(
        jnp.where(lens > 0, 1, 0)
    )
    fc = [jnp.int32(0)] * (L + 1)
    for l in range(1, L + 1):
        fc[l] = (fc[l - 1] + cnt[l - 1]) << 1

    # rank within same length = # earlier symbols with the same length
    syms = jnp.arange(S, dtype=jnp.int32)
    sort_key = jnp.where(lens > 0, lens, L + 1) * (2 * S) + syms
    _, order = jax.lax.sort((sort_key, syms), num_keys=1)
    # position in sorted list, back in symbol order
    pos_sorted = jnp.arange(S, dtype=jnp.int32)
    pos = jax.lax.sort((order, pos_sorted), num_keys=1)[1]
    cum = [jnp.int32(0)] * (L + 1)
    for l in range(1, L + 1):
        cum[l] = cum[l - 1] + cnt[l - 1]
    fcv = jnp.zeros((S,), jnp.int32)
    cumv = jnp.zeros((S,), jnp.int32)
    for l in range(1, L + 1):
        m = lens == l
        fcv = jnp.where(m, fc[l], fcv)
        cumv = jnp.where(m, cum[l], cumv)
    codes = jnp.where(lens > 0, fcv + (pos - cumv), 0)
    return codes.astype(jnp.uint32), lens
