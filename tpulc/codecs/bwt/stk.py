"""ST-k bounded-context sort transform (Schindler transform).

libbsc's GPU block sorter (`st2.cu:292-432`: pack following k chars
into fixed-width keys, one radix sort, emit preceding chars) — the
simplest BWT variant here: ONE `lax.sort` with packed keys, no
doubling loop.

Forward (device): key = next k bytes (cyclic) packed into two uint32;
stable sort with position tiebreak; output last column + index of
rotation 0 — nothing else is stored.

Inverse (device + native C): the context string of every output slot
is reconstructed on device with the classic prepend-sort identity
(ctx_t = ctx_1 gathered through powers of the stable sort-by-L
permutation — k-1 gathers), then a serial backward walk assigns
predecessors: a slot's PREDECESSOR context (L[j] + first k-1 context
chars) is fully known, equal-full-context slots are position-ordered,
and the walk visits positions in decreasing order, so consuming each
context group from its end is exact.  The walk is the native C stage
`st_gold_inverse` (the successor relation is not a static permutation,
which is exactly why bsc's inverse ST is CPU-side and bucket-based,
`st.cpp:1029+`).
"""

from __future__ import annotations

from functools import partial

import ctypes

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("k",))
def st_encode(data: jax.Array, k: int = 8):
    """ST-k of uint8[n] -> (last uint8[n], idx0 int32)."""
    n = data.shape[0]
    b = data.astype(jnp.uint32)
    hi = jnp.zeros((n,), jnp.uint32)
    lo = jnp.zeros((n,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | jnp.roll(b, -t)
    for t in range(4, k):
        lo = (lo << 8) | jnp.roll(b, -t)
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))  # keys are left-aligned in 64 bits
    idx = jnp.arange(n, dtype=jnp.int32)
    _, _, order = jax.lax.sort((hi, lo, idx), num_keys=2, is_stable=True)
    last = data[(order - 1) % n]
    idx0 = jnp.argmax(order == 0).astype(jnp.int32)
    return last, idx0


@partial(jax.jit, static_argnames=("k",))
def st_context_keys(last: jax.Array, k: int = 8):
    """Reconstruct each slot's k-byte context on device.

    ctx char t of slot j equals ctx char t-1 of slot P[j], where P is
    the stable sort-by-L permutation; ctx char 0 is the sorted multiset
    of L.  Returns (hi uint32[n], lo uint32[n]) packed context keys
    (zero-padded low bytes when k < 8).
    """
    n = last.shape[0]
    sym = last.astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    s_sorted, P = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    chars = [s_sorted.astype(jnp.uint32)]  # ctx char 0 per slot
    cur = s_sorted.astype(jnp.uint32)
    for _ in range(k - 1):
        cur = cur[P]  # ctx char t of slot j = ctx char t-1 of P[j]
        chars.append(cur)
    hi = jnp.zeros((n,), jnp.uint32)
    lo = jnp.zeros((n,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | chars[t]
    for t in range(4, k):
        lo = (lo << 8) | chars[t]
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))
    return hi, lo


@partial(jax.jit, static_argnames=("k",))
def st_encode_masked(data: jax.Array, n: jax.Array, k: int = 8):
    """ST-k of the first n bytes of uint8[cap] -> (last uint8[cap]
    valid prefix n, idx0 int32).

    Fixed compiled shape at traced valid length (same scheme as
    `masked.bwt_encode_masked`): cyclic k-byte keys come from wrap
    slices of a doubled buffer, padding rows sort after every real row
    and never move.  ONE stable sort total — the reason ST-k is the
    cheap sorter for 25 MB bsc blocks (`st2.cu:292-432` is the
    same shape: presort key pack, one radix sort, postsort).
    """
    from tpulc.codecs.bwt.masked import _doubled, _wrap_slice

    cap = data.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    nn = jnp.maximum(n, 1)
    d2 = _doubled(data.astype(jnp.uint32), nn, 0)
    bs = [data.astype(jnp.uint32)] + [
        _wrap_slice(d2, jnp.int32(t) % nn, cap) for t in range(1, k)
    ]
    hi = jnp.zeros((cap,), jnp.uint32)
    lo = jnp.zeros((cap,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | bs[t]
    for t in range(4, k):
        lo = (lo << 8) | bs[t]
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))  # keys are left-aligned in 64 bits
    prim = jnp.where(real, 0, 1)
    hi = jnp.where(real, hi, idx.astype(jnp.uint32))
    lo = jnp.where(real, lo, 0)
    d2u8 = _doubled(data, nn, jnp.uint8(0))
    prev = _wrap_slice(d2u8, (nn - 1) % nn, cap)  # prev[i]=data[(i-1)%n]
    _, _, _, order, last = jax.lax.sort(
        (prim, hi, lo, idx, prev), num_keys=4, is_stable=True
    )
    last = jnp.where(real, last, 0).astype(jnp.uint8)
    idx0 = jnp.argmax((order == 0) & real).astype(jnp.int32)
    return last, idx0


@partial(jax.jit, static_argnames=("k",))
def st_context_keys_masked(last: jax.Array, n: jax.Array, k: int = 8):
    """`st_context_keys` over the valid prefix n of uint8[cap].

    Pad rows sort after every real symbol and self-compose harmlessly;
    only rows < n of the returned keys are meaningful.
    """
    cap = last.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    sym = jnp.where(real, last.astype(jnp.int32), 256 + idx)
    s_sorted, P = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    chars = [jnp.minimum(s_sorted, 255).astype(jnp.uint32)]
    cur = chars[0]
    for _ in range(k - 1):
        cur = cur[P]
        chars.append(cur)
    hi = jnp.zeros((cap,), jnp.uint32)
    lo = jnp.zeros((cap,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | chars[t]
    for t in range(4, k):
        lo = (lo << 8) | chars[t]
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))
    return hi, lo


def st_decode(last: np.ndarray, idx0: int, k: int = 8) -> np.ndarray:
    """Inverse ST-k: device context reconstruction + native C walk."""
    from tpulc.gold.lzss_gold import _load, _as_buf

    n = len(last)
    hi, lo = st_context_keys(jnp.asarray(last), k)
    hi = np.ascontiguousarray(np.asarray(hi), np.uint32)
    lo = np.ascontiguousarray(np.asarray(lo), np.uint32)
    lastc = np.ascontiguousarray(last, np.uint8)
    out = np.zeros(n, np.uint8)
    lib = _load()
    fn = lib.st_gold_inverse
    if not getattr(fn, "_configured", False):
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        fn._configured = True
    r = fn(
        _as_buf(lastc), n,
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        int(idx0), k, _as_buf(out),
    )
    if r < 0:
        raise ValueError("inverse ST failed")
    return out


def st_encode_np(data, k: int = 8):
    """Naive gold: sort positions by following-k-gram (cyclic), stable."""
    arr = np.asarray(data, np.uint8)
    n = len(arr)
    doubled = np.concatenate([arr, arr])
    keys = [tuple(doubled[i: i + k]) for i in range(n)]
    order = sorted(range(n), key=lambda i: (keys[i], i))
    last = np.array([arr[(i - 1) % n] for i in order], np.uint8)
    return last, order.index(0)


@partial(jax.jit, static_argnames=("k",))
def st_encode_with_next(data: jax.Array, k: int = 8):
    """ST-k forward that also returns the NEXT-char stream F:
    F[j] = data[(pos(j) + k) mod n] — the one extra column that makes
    the inverse a static permutation (see `st_decode_device`).

    F rides the forward sort as a payload operand, so it is free at
    encode time; wiring it costs one extra entropy-coded stream (the
    decode-side parallelism trade libbsc cannot make because it does
    not own the container format — its inverse ST is a serial CPU walk,
    `st.cpp:1029+`)."""
    n = data.shape[0]
    b = data.astype(jnp.uint32)
    hi = jnp.zeros((n,), jnp.uint32)
    lo = jnp.zeros((n,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | jnp.roll(b, -t)
    for t in range(4, k):
        lo = (lo << 8) | jnp.roll(b, -t)
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))
    idx = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.roll(data, 1)
    nxt = jnp.roll(data, -k)
    _, _, order, last, fnext = jax.lax.sort(
        (hi, lo, idx, prev, nxt), num_keys=2, is_stable=True
    )
    idx0 = jnp.argmax(order == 0).astype(jnp.int32)
    return last, fnext, idx0


@partial(jax.jit, static_argnames=("k",))
def st_predecessor_perm(last: jax.Array, fnext: jax.Array,
                        idx0: jax.Array, k: int = 8):
    """Static predecessor permutation of the ST-k slots, given the
    next-char stream F.

    Identity: slot j (position p) and its predecessor slot (position
    p-1) both name the cyclic (k+1)-gram starting at p-1 — j through
    (L[j], ctx[j]) and the predecessor through (ctx, F).  Occurrences
    of one (k+1)-gram sort by position on BOTH sides (slot order within
    equal keys is position order), so the i-th child pairs with the
    i-th parent: two stable sorts build the whole map, no walk."""
    n = last.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # per-slot context chars (prepend-sort identity, as st_context_keys)
    sym = last.astype(jnp.int32)
    s_sorted, P = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    chars = [s_sorted.astype(jnp.uint32)]
    cur = chars[0]
    for _ in range(k - 1):
        cur = cur[P]
        chars.append(cur)

    def pack3(byte_list):
        """<=12 bytes, big-endian left-aligned -> three u32 key words."""
        bs = byte_list + [jnp.zeros((n,), jnp.uint32)] * (12 - len(byte_list))
        words = []
        for w in range(3):
            acc = jnp.zeros((n,), jnp.uint32)
            for t in range(4):
                acc = (acc << 8) | bs[4 * w + t]
            words.append(acc)
        return words

    Lw = last.astype(jnp.uint32)
    Fw = fnext.astype(jnp.uint32)
    # child key:  L[j] ++ ctx[j]  (the (k+1)-gram at pos-1)
    # parent key: ctx[j] ++ F[j]  (the (k+1)-gram at pos)
    ca, cb, cc = pack3([Lw] + chars)
    pa, pb, pc = pack3(chars + [Fw])
    # Cyclic wrap: child position p pairs with parent position
    # (p-1) mod n, which is order-preserving EXCEPT for p = 0, whose
    # parent sits at n-1 (the largest).  The position-0 slot is idx0
    # (wired), so an extra sort key pushes exactly that child to the
    # END of its gram group, where the n-1 parent ranks.
    wrap = (idx == idx0).astype(jnp.uint32)
    _, _, _, _, child = jax.lax.sort((ca, cb, cc, wrap, idx),
                                     num_keys=4, is_stable=True)
    _, _, _, parent = jax.lax.sort((pa, pb, pc, idx), num_keys=3,
                                   is_stable=True)
    # P[child[i]] = parent[i]: un-permute via one key-value sort
    return jax.lax.sort((child, parent), num_keys=1)[1]


@partial(jax.jit, static_argnames=("k",))
def st_encode_with_next_masked(padded: jax.Array, n: jax.Array,
                               k: int = 8):
    """`st_encode_masked` that also returns the next-char stream F
    (valid prefix n): F[j] = data[(pos(j) + k) mod n] — the wired
    column that makes the inverse a static permutation (see
    `st_decode_device_masked`)."""
    from tpulc.codecs.bwt.masked import _doubled, _wrap_slice

    cap = padded.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    nn = jnp.maximum(n, 1)
    d2 = _doubled(padded.astype(jnp.uint32), nn, 0)
    bs = [padded.astype(jnp.uint32)] + [
        _wrap_slice(d2, jnp.int32(t) % nn, cap) for t in range(1, k)
    ]
    hi = jnp.zeros((cap,), jnp.uint32)
    lo = jnp.zeros((cap,), jnp.uint32)
    for t in range(min(k, 4)):
        hi = (hi << 8) | bs[t]
    for t in range(4, k):
        lo = (lo << 8) | bs[t]
    if k < 4:
        hi = hi << (8 * (4 - k))
    if 4 < k < 8:
        lo = lo << (8 * (8 - k))
    prim = jnp.where(real, 0, 1)
    hi = jnp.where(real, hi, idx.astype(jnp.uint32))
    lo = jnp.where(real, lo, 0)
    d2u8 = _doubled(padded, nn, jnp.uint8(0))
    prev = _wrap_slice(d2u8, (nn - 1) % nn, cap)
    nxt = _wrap_slice(d2u8, jnp.int32(k) % nn, cap)
    _, _, _, order, last, fnext = jax.lax.sort(
        (prim, hi, lo, idx, prev, nxt), num_keys=4, is_stable=True
    )
    last = jnp.where(real, last, 0).astype(jnp.uint8)
    fnext = jnp.where(real, fnext, 0).astype(jnp.uint8)
    idx0 = jnp.argmax((order == 0) & real).astype(jnp.int32)
    return last, fnext, idx0


def _pack3_keys(byte_list, cap):
    """<=12 big-endian left-aligned bytes -> three u32 key words."""
    bs = byte_list + [jnp.zeros((cap,), jnp.uint32)] * (12 - len(byte_list))
    words = []
    for w in range(3):
        acc = jnp.zeros((cap,), jnp.uint32)
        for t in range(4):
            acc = (acc << 8) | bs[4 * w + t]
        words.append(acc)
    return words


@partial(jax.jit, static_argnames=("k",))
def st_predecessor_perm_masked(last: jax.Array, fnext: jax.Array,
                               idx0: jax.Array, n: jax.Array,
                               k: int = 8):
    """`st_predecessor_perm` over the valid prefix n of uint8[cap].

    Pad rows (idx >= n) carry a primary pad key plus their own index,
    so each pad child pairs with itself on the parent side: P is the
    identity on pads (harmless self-loops off the idx0 cycle)."""
    cap = last.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    real = idx < n
    sym = jnp.where(real, last.astype(jnp.int32), 256 + idx)
    s_sorted, P = jax.lax.sort((sym, idx), num_keys=1, is_stable=True)
    chars = [jnp.minimum(s_sorted, 255).astype(jnp.uint32)]
    cur = chars[0]
    for _ in range(k - 1):
        cur = cur[P]
        chars.append(cur)
    Lw = last.astype(jnp.uint32)
    Fw = fnext.astype(jnp.uint32)
    ca, cb, cc = _pack3_keys([Lw] + chars, cap)
    pa, pb, pc = _pack3_keys(chars + [Fw], cap)
    prim = jnp.where(real, 0, 1)
    padk = idx.astype(jnp.uint32)
    ca = jnp.where(real, ca, padk)
    cb = jnp.where(real, cb, 0)
    cc = jnp.where(real, cc, 0)
    pa = jnp.where(real, pa, padk)
    pb = jnp.where(real, pb, 0)
    pc = jnp.where(real, pc, 0)
    wrap = ((idx == idx0) & real).astype(jnp.uint32)
    _, _, _, _, _, child = jax.lax.sort(
        (prim, ca, cb, cc, wrap, idx), num_keys=5, is_stable=True)
    _, _, _, _, parent = jax.lax.sort(
        (prim, pa, pb, pc, idx), num_keys=4, is_stable=True)
    return jax.lax.sort((child, parent), num_keys=1)[1]


@partial(jax.jit, static_argnames=("k",))
def st_decode_device_masked(last: jax.Array, fnext: jax.Array,
                            idx0: jax.Array, n: jax.Array, k: int = 8):
    """Device inverse ST-k over the valid prefix n of uint8[cap]
    (wired-F mode): masked predecessor permutation + the same
    pointer-doubling walk as `st_decode_device`.  Returns uint8[cap]
    with the recovered text in [0, n)."""
    cap = last.shape[0]
    last = jnp.where(jnp.arange(cap, dtype=jnp.int32) < n, last, 0)
    P = st_predecessor_perm_masked(last, fnext, idx0, n, k)
    rounds = max(1, (cap - 1).bit_length())
    state0 = jnp.stack([P, jnp.ones((cap,), jnp.int32)], axis=1)

    def round_body(_, state):
        ptr = state[:, 0]
        tgt = state[ptr]
        live = (ptr != idx0)[:, None]
        upd = jnp.stack([tgt[:, 0], state[:, 1] + tgt[:, 1]], axis=1)
        return jnp.where(live, upd, state)

    state = jax.lax.fori_loop(0, rounds, round_body, state0)
    ptr, d = state[:, 0], state[:, 1]
    in_cycle = ptr == idx0
    p = jnp.maximum(d[idx0], 1)
    slot = jnp.where(in_cycle, (p - d) % p, cap)
    _, cyc = jax.lax.sort((slot, last), num_keys=1)
    j = jnp.arange(cap, dtype=jnp.int32)
    return cyc[(n - 1 - j) % p]


@partial(jax.jit, static_argnames=("k",))
def st_decode_device(last: jax.Array, fnext: jax.Array, idx0: jax.Array,
                     k: int = 8):
    """Fully device-resident inverse ST-k (requires the wired F
    stream): build the static predecessor permutation, then recover the
    text with the same pointer-doubling walk as `rotsort.bwt_decode`.
    out[p-1] = L[slot of p] applied backward from position 0's slot."""
    n = last.shape[0]
    P = st_predecessor_perm(last, fnext, idx0, k)
    idx = jnp.arange(n, dtype=jnp.int32)
    # position-0 slot is idx0; walking P from idx0 visits positions
    # n-1, n-2, ... (predecessors), emitting L at each step.
    rounds = max(1, (n - 1).bit_length())
    state0 = jnp.stack([P, jnp.ones((n,), jnp.int32)], axis=1)

    def round_body(_, state):
        ptr = state[:, 0]
        tgt = state[ptr]
        live = (ptr != idx0)[:, None]
        upd = jnp.stack([tgt[:, 0], state[:, 1] + tgt[:, 1]], axis=1)
        return jnp.where(live, upd, state)

    state = jax.lax.fori_loop(0, rounds, round_body, state0)
    ptr, d = state[:, 0], state[:, 1]
    in_cycle = ptr == idx0
    p = d[idx0]
    # node j visited at step k == (p - d[j]) mod p; step k emits
    # out[(n-1-k) mod n] = last[j_k] where j_0 = idx0's... walk starts
    # at idx0 (position 0): its predecessor holds position n-1.
    slot = jnp.where(in_cycle, (p - d) % p, n)
    _, cyc = jax.lax.sort((slot, last), num_keys=1)
    j = jnp.arange(n, dtype=jnp.int32)
    return cyc[(n - 1 - j) % p]
