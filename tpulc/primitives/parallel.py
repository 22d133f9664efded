"""Data-parallel primitive library (the L1 layer, SURVEY.md §1).

The reference vendors ~100k LoC of GPU primitives (cub radix sort,
moderngpu scan/merge, thrust, b40c — §2.4 "Primitive library") and
cudpp exposes them as its public API (`cudpp.h:200-363`).  In JAX these
are `jax.lax` one-liners; this module gives them the cudpp-shaped
surface (scan / segmented scan / compact / reduce / sorts / merge) so
codec code and users have one place to reach for them, with tests
pinning semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def scan(x, op=jnp.add, exclusive: bool = False, reverse: bool = False):
    """cudppScan: inclusive/exclusive forward/backward scans."""
    assoc = {jnp.add: jnp.add, jnp.maximum: jnp.maximum,
             jnp.minimum: jnp.minimum}.get(op, op)
    incl = jax.lax.associative_scan(assoc, x, reverse=reverse, axis=0)
    if not exclusive:
        return incl
    ident = _identity_for(op, x.dtype)
    if reverse:
        return jnp.concatenate([incl[1:], jnp.full((1,), ident, x.dtype)])
    return jnp.concatenate([jnp.full((1,), ident, x.dtype), incl[:-1]])


def multi_scan(x, op=jnp.add, exclusive: bool = False,
               reverse: bool = False):
    """cudppMultiScan (`cudpp.h` multiScan entry, `app/scan_app.cu`):
    independent scans over each ROW of a 2-D array.

    cudpp launches one scan per row with shared block code; here the
    rows vectorize as a batched associative scan (vmap over axis 0),
    one fused program for the whole matrix."""
    if x.ndim != 2:
        raise ValueError("multi_scan expects a 2-D [rows, cols] array")
    return jax.vmap(
        lambda r: scan(r, op=op, exclusive=exclusive, reverse=reverse)
    )(x)


def _identity_for(op, dtype):
    if op is jnp.add:
        return 0
    if op is jnp.maximum:
        return jnp.iinfo(dtype).min if jnp.issubdtype(dtype, jnp.integer) \
            else -jnp.inf
    if op is jnp.minimum:
        return jnp.iinfo(dtype).max if jnp.issubdtype(dtype, jnp.integer) \
            else jnp.inf
    raise ValueError("unknown identity")


def segmented_scan(x, flags, op=jnp.add):
    """cudppSegmentedScan: inclusive scan restarting at flag positions.

    Implemented as an associative scan over (value, flag) pairs — the
    classic segmented-scan monoid.
    """

    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, op(av, bv)), af | bf

    vals, _ = jax.lax.associative_scan(
        combine, (x, flags.astype(bool)), axis=0
    )
    return vals


def compact(x, mask, fill=0):
    """cudppCompact: stable-compact masked elements to the front.

    Returns (compacted array of same length padded with `fill`, count).
    """
    n = x.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - mask.astype(jnp.int32)
    tgt = jnp.where(mask, pos, n)
    out = jnp.full((n,), fill, x.dtype).at[tgt].set(x, mode="drop")
    return out, jnp.sum(mask.astype(jnp.int32))


def reduce(x, op=jnp.add):
    """cudppReduce."""
    if op is jnp.add:
        return jnp.sum(x)
    if op is jnp.maximum:
        return jnp.max(x)
    if op is jnp.minimum:
        return jnp.min(x)
    raise ValueError("unknown op")


def sort_pairs(keys, values, stable: bool = True):
    """cudppRadixSort/cudppMergeSort: key-value sort."""
    k, v = jax.lax.sort((keys, values), num_keys=1, is_stable=stable)
    return k, v


def sort_strings(packed_prefix, indices):
    """cudppStringSort's role for fixed packed prefixes: sort uint32
    prefix keys carrying string indices (ties keep index order)."""
    return sort_pairs(packed_prefix, indices)


def sort_strings_full(chars, starts):
    """Full variable-length cudppStringSort (`apps/.../stringsort`):
    lexicographically order null-terminated strings packed in `chars`
    (uint8[n], 0 after each string), given their start offsets.

    Suffix ranks of the concatenation order the strings directly: the
    0 terminator sorts below every character, so comparison effectively
    stops at the shorter string's end — the same reduction cudpp's BWT
    path uses, here on the prefix-doubling suffix array.  Equal strings
    tie-break by what follows them (cudpp leaves equal-key order
    unspecified too).
    """
    from tpulc.primitives.suffix import suffix_array

    sa = suffix_array(chars)
    n = chars.shape[0]
    # rank[i] = position of suffix i in sorted order
    rank = jnp.zeros((n,), jnp.int32).at[sa].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    keys = rank[starts]
    _, order = sort_pairs(keys, jnp.arange(starts.shape[0],
                                           dtype=jnp.int32))
    return order


def merge_sorted(a, b):
    """moderngpu Merge: merge two sorted arrays (same dtype)."""
    both = jnp.concatenate([a, b])
    return jnp.sort(both)


def multisplit(x, buckets, num_buckets: int):
    """cudppMultiSplit: stable partition by bucket id.

    Returns (reordered values, bucket start offsets [num_buckets]).
    """
    b, v = jax.lax.sort(
        (buckets.astype(jnp.int32), x), num_keys=1, is_stable=True
    )
    counts = jnp.zeros((num_buckets,), jnp.int32).at[b].add(1, mode="drop")
    starts = jnp.cumsum(counts) - counts
    return v, starts


def listrank(next_idx, head):
    """cudppListRank: rank of each node along a linked list, by pointer
    doubling (the machinery behind tpulc's inverse BWT)."""
    n = next_idx.shape[0]
    rounds = max(1, (n - 1).bit_length())
    state = jnp.stack(
        [next_idx, jnp.ones((n,), jnp.int32)], axis=1
    )

    def body(_, st):
        ptr = st[:, 0]
        tgt = st[ptr]
        live = (ptr != head)[:, None]
        upd = jnp.stack([tgt[:, 0], st[:, 1] + tgt[:, 1]], axis=1)
        return jnp.where(live, upd, st)

    st = jax.lax.fori_loop(0, rounds, body, state)
    d = st[:, 1]
    total = d[head]
    return (total - d) % jnp.maximum(total, 1)


def orbit_flags(jump_e, n: int, t_max: int):
    """Membership flags of the orbit of 0 under a jump table.

    jump_e: int32[n+1] with every entry in (i, n] for i < n and
    jump_e[n] == n (absorbing end).  Returns bool[n]: True where the
    chain 0 -> jump_e[0] -> ... lands.  `t_max` bounds the orbit length
    (<= n; callers pass n / min_step).

    Design note: this replaces scatter-max pointer-doubling
    reachability (log2(n) batched scatters) with orbit
    ENUMERATION by gather-only path doubling: after round k the table F
    jumps 2^k steps and positions P[0:2^k] are final, so
    P[2^k:2^{k+1}] = F[P[0:2^k]] — log2(t_max) gathers plus exactly one
    final scatter of the landing set.  This is the greedy-parse /
    group-chain workhorse of the LZ codecs.
    """
    T = 1
    while T < t_max:
        T *= 2
    P = jnp.full((T,), n, jnp.int32).at[0].set(0)
    F = jump_e
    step = 1
    while step < T:
        P = jax.lax.dynamic_update_slice(P, F[P[:step]], (step,))
        if step * 2 < T:
            F = F[F]
        step *= 2
    flags = jnp.zeros((n + 1,), bool).at[jnp.minimum(P, n)].set(
        True, mode="drop"
    )
    return flags[:n]
