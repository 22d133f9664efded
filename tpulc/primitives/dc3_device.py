"""Device DC3 / skew suffix array (one sample level + doubling).

JAX realization of cudpp's recursive DC3 (`sa_app.cu:125-365`).  The
XLA obstacles and their resolutions:

  - *data-dependent recursion depth* (host-read `unique` flag,
    `sa_app.cu:190-195`): the 2/3-sample recursion is replaced by rank
    doubling over the sample's name string — a `lax.while_loop` whose
    early exit IS DC3's "names unique" shortcut, with no host sync.
  - *custom-comparator merge* (`mgpu::MergePairs` with `my_less`,
    `sa_app.cu:27-35,292`): XLA sorts have no custom comparators, but
    the three class-pair orders are each expressible with PLAIN key
    sorts — mod1-vs-mod2 from sample ranks, and the two unions
    mod0∪mod1 (key: char, succ-rank) and mod0∪mod2 (key: char, char,
    rank) — and pairwise orders determine every suffix's global rank
    by counting:  global(x) = own_rank(x) + Σ cross-class counts,
    where each cross count = position-in-union-sort − own_rank.
  - *strided sample access*: every t[pos12+j] / rank[pos0+j] is a
    static strided slice (free), never a gather.

All sizes are static functions of n, so the whole construction is one
compiled program per input length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpulc.codecs.bwt.rotsort import _scatter_perm

_FAN = 6  # rank keys per doubling round (cf. rotsort._FAN)


def _dense_rank(keys, idx, base: int = 0):
    """Dense 0-based rank of each element under ascending key order
    (ties share a rank); also returns (sorted keys, order)."""
    out = jax.lax.sort((*keys, idx), num_keys=len(keys), is_stable=True)
    order = out[-1]
    diff = out[0][1:] != out[0][:-1]
    for kk in out[1:-1]:
        diff = diff | (kk[1:] != kk[:-1])
    grp = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), diff.astype(jnp.int32)]
    )
    rank = _scatter_perm(order, jnp.cumsum(grp) + base)
    return rank, order, diff


def _suffix_ranks(vals):
    """Unique 0-based suffix ranks of int32[m] by fan-6 doubling.

    Overshoot keys are -1-overshoot so shorter suffixes order first at
    every depth (end-of-string sentinel semantics)."""
    m = vals.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    rank, _, _ = _dense_rank((vals,), idx)

    def cond(state):
        rank, k = state
        return (k < m) & (jnp.max(rank) < m - 1)

    def body(state):
        rank, k = state
        keys = [rank]
        for j in range(1, _FAN):
            over = idx + j * k - m
            keys.append(
                jnp.where(over < 0, jnp.roll(rank, -j * k), -1 - over)
            )
        out = jax.lax.sort((*keys, idx), num_keys=_FAN, is_stable=True)
        order = out[_FAN]
        diff = out[0][1:] != out[0][:-1]
        for r in out[1:_FAN]:
            diff = diff | (r[1:] != r[:-1])
        newgrp = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), diff.astype(jnp.int32)]
        )
        rank = _scatter_perm(order, jnp.cumsum(newgrp))
        return rank, k * _FAN

    rank, _ = jax.lax.while_loop(cond, body, (rank, jnp.int32(1)))
    return rank


@jax.jit
def suffix_array_dc3(data: jax.Array) -> jax.Array:
    """SA of uint8[n] via one DC3 sample level + doubling (n >= 4)."""
    n = data.shape[0]
    assert n >= 4, "use primitives.suffix.suffix_array for tiny inputs"
    t = jnp.concatenate(
        [data.astype(jnp.int32) + 1, jnp.zeros((4,), jnp.int32)]
    )  # symbols >= 1; 0 = sentinel

    has_dummy = n % 3 == 1            # static
    ntot = n + (1 if has_dummy else 0)
    n1p = len(range(1, ntot, 3))      # class-1 incl. dummy
    n2 = len(range(2, ntot, 3))
    n0 = len(range(0, n, 3))
    m = n1p + n2

    # --- sample triple sort (strided slices, one 3-key sort) ---------
    def tr(start):
        sl = t[start: start + ntot]
        return jnp.concatenate([sl[1::3], sl[2::3]])

    pos12 = jnp.asarray(
        list(range(1, ntot, 3)) + list(range(2, ntot, 3)), jnp.int32
    )
    c0, c1, c2 = tr(0), tr(1), tr(2)
    srank, _, _ = _dense_rank(
        (c0, c1, c2), jnp.arange(m, dtype=jnp.int32)
    )
    # names in sample-slot order (class1 block then class2 block), >= 1
    names = srank + 1

    # --- recursion replaced by doubling over the name string ---------
    # rec = [names at 1,4,7,...(incl dummy), names at 2,5,8,...]; its
    # suffix ranks ARE the sample suffix order (Kärkkäinen–Sanders).
    rec = names  # already in (class1 text order ++ class2 text order)
    rrank = _suffix_ranks(rec)        # unique 0-based, length m

    # Drop the dummy sample (rank adjust, no compaction): every rank
    # above the dummy's shifts down one.
    if has_dummy:
        dummy_rank = rrank[n1p - 1]   # dummy sits at slot n1p-1
        r12s = jnp.where(rrank > dummy_rank, rrank - 1, rrank)
        r12s = r12s.at[n1p - 1].set(-1)
    else:
        r12s = rrank

    # rank over text positions (1-based; 0 beyond end / non-sample)
    rank_arr = jnp.zeros((n + 4,), jnp.int32)
    rank_arr = rank_arr.at[pos12].set(r12s + 1, mode="drop")

    # --- SA0: class-0 induced sort ----------------------------------
    t0 = t[0:n:3]
    rsucc0 = rank_arr[1: n + 1: 3]
    idx0v = jnp.arange(n0, dtype=jnp.int32)
    rank0, _, _ = _dense_rank((t0, rsucc0), idx0v)
    # (t0, rank of successor) is a strict order for class-0 suffixes,
    # so rank0 is already unique.

    # --- own-ranks of class 1 / class 2 among themselves -------------
    r1_text = rank_arr[1: n + 1: 3][: len(range(1, n, 3))]  # 1-based
    r2_text = rank_arr[2: n + 1: 3][: len(range(2, n, 3))]
    n1 = r1_text.shape[0]
    own1 = _dense_rank((r1_text,), jnp.arange(n1, dtype=jnp.int32))[0]
    own2 = _dense_rank((r2_text,), jnp.arange(n2, dtype=jnp.int32))[0]

    # --- union sorts -------------------------------------------------
    # B = mod0 ∪ mod1, key (t[i], rank[i+1])
    kB_t = jnp.concatenate([t0, t[1:n:3]])
    kB_r = jnp.concatenate([rsucc0, rank_arr[2: n + 2: 3][:n1]])
    idxB = jnp.arange(n0 + n1, dtype=jnp.int32)
    posB, _, _ = _dense_rank((kB_t, kB_r), idxB)
    # strict: mod0-vs-mod0 strict (above), mod1-vs-mod1 strict (sample
    # ranks), mod0-vs-mod1 strict (distinct suffixes) => dense rank is
    # a permutation here.

    # A = mod0 ∪ mod2, key (t[i], t[i+1], rank[i+2])
    kA_t = jnp.concatenate([t0, t[2:n:3]])
    kA_u = jnp.concatenate([t[1: n + 1: 3], t[3: n + 3: 3][:n2]])
    kA_r = jnp.concatenate([rank_arr[2: n + 2: 3][:n0],
                            rank_arr[4: n + 4: 3][:n2]])
    idxA = jnp.arange(n0 + n2, dtype=jnp.int32)
    posA, _, _ = _dense_rank((kA_t, kA_u, kA_r), idxA)

    posA0, posA2 = posA[:n0], posA[n0:]
    posB0, posB1 = posB[:n0], posB[n0:]

    # --- global positions by pairwise counting -----------------------
    g0 = posA0 + posB0 - rank0
    g1 = posB1 + (r1_text - 1) - own1
    g2 = posA2 + (r2_text - 1) - own2

    g = jnp.concatenate([g0, g1, g2])
    p = jnp.concatenate([
        jnp.arange(0, n, 3, dtype=jnp.int32),
        jnp.arange(1, n, 3, dtype=jnp.int32),
        jnp.arange(2, n, 3, dtype=jnp.int32),
    ])
    return jax.lax.sort((g, p), num_keys=1)[1]
