"""Rotation-sort BWT by prefix doubling; inverse by pointer doubling.

Forward — the bzip2-family BWT sorts all n cyclic rotations
(`cuda-bzip2-ipdpsw/blocksort.c`, GPU variant `gpuBWTSort.cu:202-480`
doubles a 2/3 sample then merges on the CPU).  This version prefix-
doubles over *all* rotations directly: rank vectors refine through
log2(n) stable two-key sorts (`lax.sort`), with wraparound indexing
giving rotation (not suffix) order for free.  No host merge, no
recursion, fixed-shape loop state — a `lax.while_loop` exits early once
ranks are unique (typical for real data well before log2(n) rounds).

Inverse — the serial LF walk (`decompress.c`, `bwt.cpp:359`) is a
cyclic linked-list traversal, inherently sequential.  Here it becomes
pointer doubling: log2(n) rounds of jump composition compute every
position's distance to the primary index, which IS its output position
(modulo the cycle length — periodic inputs make the LF permutation
multi-cyclic, and the modulo handles exactly that case; libbsc's
restart-index parallel unbwt, `bwt.cpp:359`, solves the same problem
with stored metadata, which this formulation does not need).

Design note: permutation application/inversion goes through sorts
rather than random scatters and gathers: inverting a
permutation is one key-value sort (`_scatter_perm`), and the BWT last
column rides the final sort as a payload operand instead of a gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _scatter_perm(order: jax.Array, values: jax.Array) -> jax.Array:
    """out[order[i]] = values[i] for a permutation `order` — via one
    key-value sort."""
    return jax.lax.sort((order, values), num_keys=1)[1]


# Ranks composed per round: prefix length multiplies by _FAN each
# round.  With the 8-byte initial key the depth trajectory is
# 8 -> 64 -> 512: measured on text-like blocks (bench corpus needs
# depth 33..64), fan 8 resolves in ONE 9-operand refinement round where
# fan 6 from a 4-byte key (4 -> 24 -> 144) needed two.
_FAN = 8


def _zero_run_mask(data, idx, n):
    """int32[n] mask of the maximal cyclic zero run through the block
    boundary (trailing + leading zeros).  Rotations starting inside one
    maximal zero run first differ at the run-terminating byte (nonzero,
    hence greater) — so their lexicographic order IS ascending position
    and rank refinement never needs to separate them.  Driver blocks
    are zero-padded to a fixed capacity; this makes refinement depth
    independent of the pad length (a short last block would otherwise
    force k >= pad_len, i.e. several extra full-size sort rounds)."""
    nz = data != 0
    any_nz = jnp.any(nz)
    first_nz = jnp.argmax(nz).astype(jnp.int32)
    last_nz = n - 1 - jnp.argmax(nz[::-1]).astype(jnp.int32)
    in_run = ((idx > last_nz) | (idx < first_nz)) & any_nz
    return in_run.astype(jnp.int32)


def _tied_rows(diff):
    """Per-sorted-row 'group size > 1' flags from lead-row flags.
    diff[j] (bool[n-1]) marks row j+1 starting a new group."""
    lead = jnp.concatenate([jnp.ones((1,), jnp.bool_), diff])
    trail = jnp.concatenate([diff, jnp.ones((1,), jnp.bool_)])
    return ~(lead & trail)


def _refine_ranks(data, idx, n, benign_ties: bool = True):
    """Rotation ranks by generalized prefix doubling -> (rank, done).

    Each round sorts by (rank[i], rank[i+k], ..., rank[i+(F-1)k]) — all
    circular shifts, no gathers — extending the covered prefix k -> F*k
    in ONE multi-key sort: F=4 halves the round count vs classic
    doubling for a wider sort.

    With `benign_ties` the loop exits as soon as every remaining tied
    group lies inside the boundary zero run (see `_zero_run_mask`);
    callers must then break those ties by ASCENDING position.  `done`
    is True when the final ascending-tie-break order is the exact
    lexicographic rotation order (False only for inputs that exhausted
    k, e.g. fully periodic blocks).

    Periodic-pair shortcut: long-range repeated content (period P)
    leaves rotation pairs (i, i+P) tied to depth ~P, forcing the full
    round trajectory even though everything else resolved by depth
    ~512 (the reference hits the same wall: bzip2's `mainSort` work
    budget overflows into `fallbackSort`, `blocksort.c:1064`; the GPU
    variant depth-limits at 64 and merges on the CPU).  When a round
    leaves ONLY size-2 tied groups with one common distance P, each
    pair's order is the sign of the first cyclic mismatch between the
    block and its own P-rotation — a shared sign vector plus one
    first-nonzero scan, NO gathers — so the remaining rounds collapse
    into one O(n) step."""
    run = (_zero_run_mask(data, idx, n) if benign_ties
           else jnp.zeros((n,), jnp.int32))
    # (idx, run) ride the refinement sorts as ONE packed payload operand
    # (idx < 2^27 blocks; run in bit 30): one less operand to permute
    # per multi-operand sort round.
    pidx = idx | (run << 30)

    # Initial ranks from the 8-byte prefix (two packed uint32 keys):
    # one 2-key sort covers depth 8 before refinement starts.
    byte = data.astype(jnp.uint32)
    key4a = (
        (byte << 24) | (jnp.roll(byte, -1) << 16)
        | (jnp.roll(byte, -2) << 8) | jnp.roll(byte, -3)
    )
    key4b = jnp.roll(key4a, -4)
    ka_s, kb_s, p0 = jax.lax.sort(
        (key4a, key4b, pidx), num_keys=2, is_stable=True
    )
    order0 = p0 & ((1 << 30) - 1)
    run0 = p0 >> 30
    diff0 = (ka_s[1:] != ka_s[:-1]) | (kb_s[1:] != kb_s[:-1])
    grp0 = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), diff0.astype(jnp.int32)]
    )
    rank0 = _scatter_perm(order0, jnp.cumsum(grp0))
    done0 = ~jnp.any(_tied_rows(diff0) & (run0 == 0))

    data2 = jnp.concatenate([data, data])
    BIG = jnp.int32(1 << 29)

    def _pair_resolve(rank, pf_rot, ps_rot, P):
        """Resolve all (i, i+P) tied pairs at once.  v[i] = sign of the
        first position p with data[i+p] != data[i+P+p] (cyclic, one
        period window): v<0 keeps ascending order, v>0 swaps, v==0
        means truly equal rotations (decline — the caller's periodic
        fallback owns that case)."""
        shifted = jax.lax.dynamic_slice(data2, (P,), (n,))
        cmpv = jnp.sign(data.astype(jnp.int32) - shifted.astype(jnp.int32))
        cmp2 = jnp.concatenate([cmpv, cmpv])
        # first nonzero to the right via a COMMUTATIVE min-scan over
        # (position << 2 | sign+1) — "first nonzero" as a raw op is
        # non-commutative and reverse associative_scan feeds the suffix
        # accumulation as the first argument.
        idx2 = jnp.arange(2 * n, dtype=jnp.int32)
        sent = jnp.int32(1 << 30)  # > (2n-1)<<2 | 3 for n < 2^27
        enc = jnp.where(cmp2 != 0, (idx2 << 2) | (cmp2 + 1), sent)
        fnz = jax.lax.associative_scan(jnp.minimum, enc, reverse=True)
        v = jnp.where(fnz[:n] >= sent, 0, (fnz[:n] & 3) - 1)
        ok = ~jnp.any(pf_rot & (v == 0))
        v2 = jnp.concatenate([v, v])
        vP = jax.lax.dynamic_slice(v2, (n - P,), (n,))  # v[(x-P) mod n]
        loser = (pf_rot & (v > 0)) | (ps_rot & (vP < 0))
        new_rank = rank * 2 + loser.astype(jnp.int32)
        return jnp.where(ok, new_rank, rank), ok

    def cond(state):
        _, k, done = state
        return (k < n) & ~done

    def body(state):
        rank, k, _ = state
        keys = [rank] + [jnp.roll(rank, -k * j) for j in range(1, _FAN)]
        out = jax.lax.sort((*keys, pidx), num_keys=_FAN, is_stable=True)
        order = out[_FAN] & ((1 << 30) - 1)
        # sorted keys come straight from the sort operands; the rank
        # scatter is a key-value sort (see module docstring).
        diff = out[0][1:] != out[0][:-1]
        for r in out[1:_FAN]:
            diff = diff | (r[1:] != r[:-1])
        newgrp = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), diff.astype(jnp.int32)]
        )
        tied = _tied_rows(diff) & ((out[_FAN] >> 30) == 0)
        done = ~jnp.any(tied)
        # Row-space pair shape: group of exactly 2 = start row that is
        # not last, whose successor is last.
        new_grp = jnp.concatenate([jnp.ones((1,), jnp.bool_), diff])
        last_grp = jnp.concatenate([diff, jnp.ones((1,), jnp.bool_)])
        succ_last = jnp.concatenate(
            [last_grp[1:], jnp.ones((1,), jnp.bool_)]
        )
        pf_row = tied & new_grp & ~last_grp & succ_last
        ps_row = jnp.concatenate([jnp.zeros((1,), jnp.bool_),
                                  pf_row[:-1]])
        all_pairs = ~jnp.any(tied & ~(pf_row | ps_row))
        order_next = jnp.concatenate([order[1:], order[:1]])
        d = order_next - order
        dmin = jnp.min(jnp.where(pf_row, d, BIG))
        dmax = jnp.max(jnp.where(pf_row, d, -BIG))
        trigger = (~done) & all_pairs & (dmin == dmax) & (dmin > 0) \
            & (dmin < n)
        # rank + pair flags ride ONE scatter payload (rank*4 fits: the
        # rank cumsum < n <= 2^27)
        payload = jnp.cumsum(newgrp) * 4 \
            + pf_row.astype(jnp.int32) * 2 + ps_row.astype(jnp.int32)
        unpacked = _scatter_perm(order, payload)
        rank = unpacked >> 2
        pf_rot = (unpacked & 2) != 0
        ps_rot = (unpacked & 1) != 0

        def fast(_):
            new_rank, ok = _pair_resolve(rank, pf_rot, ps_rot, dmin)
            return new_rank, ok

        rank2, resolved = jax.lax.cond(
            trigger, fast, lambda _: (rank, jnp.bool_(False)), None
        )
        rank = jnp.where(trigger & resolved, rank2, rank)
        done = done | (trigger & resolved)
        return rank, k * _FAN, done

    rank, _, done = jax.lax.while_loop(
        cond, body, (rank0, jnp.int32(8), done0)
    )
    return rank, done


@partial(jax.jit, static_argnames=("tie_desc",))
def bwt_encode(data: jax.Array, tie_desc: bool = False):
    """BWT of uint8[n] -> (last column uint8[n], primary index int32).

    Ties between equal rotations (periodic inputs) resolve by original
    position — ascending by default (the inverse's cycle arithmetic
    accommodates it); `tie_desc=True` matches libbzip2's empirically
    descending tie order (needed for bit-exact .bz2 origPtr values).
    """
    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # Descending tie order must separate every distinct rotation, so the
    # benign-tie early exit (ascending-only) is off for tie_desc.
    rank, _ = _refine_ranks(data, idx, n, benign_ties=not tie_desc)
    # Final order: by rank, ties by original position.  The last column
    # and the original index ride the sort as payloads: last[j] =
    # data[(order[j]-1) mod n] = roll(data, 1)[order[j]].
    prev = jnp.roll(data, 1)
    tie_key = (n - 1) - idx if tie_desc else idx
    if tie_desc:
        # the payload rides with its row: row j of the result is
        # rotation order[j] = (n-1) - tk[j], and carries prev[order[j]].
        _, tk, last = jax.lax.sort(
            (rank, tie_key, prev), num_keys=2, is_stable=True
        )
        order = (n - 1) - tk
    else:
        _, order, last = jax.lax.sort(
            (rank, tie_key, prev), num_keys=2, is_stable=True
        )
    idx0 = jnp.argmax(order == 0).astype(jnp.int32)
    return last, idx0


@jax.jit
def bwt_decode(last: jax.Array, idx0: jax.Array) -> jax.Array:
    """Inverse BWT of uint8[n] + primary index -> uint8[n]."""
    n = last.shape[0]
    sym = last.astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    # LF map: T[j] = C[L[j]] + occ(L[j], j).  occ via stable sort of
    # (symbol, position): position j is the (rank-in-sorted)'th
    # occurrence overall, which equals C[L[j]] + occ directly.
    _, order = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    T = _scatter_perm(order, idx)

    # Pointer doubling: d[i] = steps from i to idx0 along T
    # (d[idx0] = its cycle length p).  ptr and d ride one [n, 2] array
    # so each round costs a single gather.
    rounds = max(1, (n - 1).bit_length())
    state0 = jnp.stack([T, jnp.ones((n,), jnp.int32)], axis=1)

    def round_body(_, state):
        ptr = state[:, 0]
        tgt = state[ptr]  # [n, 2] — one gather fetches ptr' and d'
        live = (ptr != idx0)[:, None]
        upd = jnp.stack([tgt[:, 0], state[:, 1] + tgt[:, 1]], axis=1)
        return jnp.where(live, upd, state)

    state = jax.lax.fori_loop(0, rounds, round_body, state0)
    ptr, d = state[:, 0], state[:, 1]
    in_cycle = ptr == idx0
    p = d[idx0]  # cycle length through idx0 (== n unless input periodic)

    # Backward-walk convention: out[n-1-k] = L[T^k(idx0)], and node i is
    # visited at k == (p - d[i]) mod p.  So out[j] = cyc[(n-1-j) mod p].
    # In-cycle slots are unique in [0, p): the slot sort compacts them
    # to the front in slot order (out-of-cycle slots sort to the tail).
    slot = jnp.where(in_cycle, (p - d) % p, n)
    _, cyc = jax.lax.sort((slot, last), num_keys=1)
    j = jnp.arange(n, dtype=jnp.int32)
    return cyc[(n - 1 - j) % p]


def bwt_encode_np(data):
    """Numpy gold: naive rotation sort (cudpp `computeBwtGold` pattern,
    `test_compress.cpp:79`)."""
    import numpy as np

    arr = np.asarray(data, np.uint8)
    n = len(arr)
    doubled = np.concatenate([arr, arr])
    rots = sorted(range(n), key=lambda i: tuple(doubled[i: i + n]))
    last = np.array([arr[(r - 1) % n] for r in rots], np.uint8)
    return last, rots.index(0)


@partial(jax.jit, static_argnames=("anchor_stride",))
def bwt_encode_anchored(data: jax.Array, anchor_stride: int = 1024):
    """BWT + decode-restart anchors (libbsc's restart-index idea,
    `bwt.cpp:359`): anchors cost ~0.1% of the block and
    turn the inverse into S-step parallel lane walks instead of log2(n)
    full-size pointer-doubling gathers).

    anchors[j] = T^(j*S)(idx0) = row((n - j*S) mod n), which is just a
    strided read of the final rank vector — free at encode time.
    Returns (last, idx0, anchors int32[R], ok bool) — ok is False when
    rotation ranks were not unique (periodic input); callers then fall
    back to the metadata-free doubling decoder.
    """
    n = data.shape[0]
    S = anchor_stride
    R = -(-n // S)
    idx = jnp.arange(n, dtype=jnp.int32)
    rank, ok = _refine_ranks(data, idx, n)
    prev = jnp.roll(data, 1)
    _, order, last = jax.lax.sort((rank, idx, prev), num_keys=1,
                                  is_stable=True)
    idx0 = jnp.argmax(order == 0).astype(jnp.int32)
    # Benign early exit leaves boundary-zero-run ties in `rank`; the
    # anchors need final ROW indices, i.e. the tie-broken inverse
    # permutation of `order`.
    rank_final = _scatter_perm(order, idx)
    j = jnp.arange(R, dtype=jnp.int32)
    anchors = rank_final[(n - j * S) % n]
    return last, idx0, anchors, ok


@partial(jax.jit, static_argnames=("anchor_stride",))
def bwt_decode_anchored(last: jax.Array, idx0: jax.Array,
                        anchors: jax.Array, anchor_stride: int = 1024):
    """Inverse BWT via anchored lane walks: each of R lanes runs S
    serial LF steps, writing rows of a step-major matrix (a cheap
    dynamic-update-slice instead of a scatter); one reverse at the end
    restores output order."""
    n = last.shape[0]
    S = anchor_stride
    R = anchors.shape[0]
    sym = last.astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    _, order = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    T = _scatter_perm(order, idx)
    del idx0  # anchors[0] == idx0 by construction

    out0 = jnp.zeros((S, R), jnp.uint8)

    if n <= (1 << 23):
        # Pack (T, last) into one int32 so each serial LF step costs a
        # single gather (the loop is latency-bound at R-sized gathers).
        TL = T | (last.astype(jnp.int32) << 23)
        mask = jnp.int32((1 << 23) - 1)

        def body(t, st):
            p, out = st
            e = TL[p]
            row = (e >> 23).astype(jnp.uint8)[None, :]
            out = jax.lax.dynamic_update_slice(out, row, (t, 0))
            return e & mask, out
    else:
        def body(t, st):
            p, out = st
            out = jax.lax.dynamic_update_slice(
                out, last[p][None, :], (t, 0)
            )
            return T[p], out

    _, out = jax.lax.fori_loop(0, S, body, (anchors, out0), unroll=4)
    lin = out.T.reshape(-1)[::-1]  # lin[R*S-1-k] = symbol at step k
    return lin[R * S - n:]
