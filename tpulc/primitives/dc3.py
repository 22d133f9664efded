"""DC3 / skew suffix-array construction (Kärkkäinen–Sanders).

The algorithm behind cudpp's GPU suffix array (`sa_app.cu:125-365`:
triple radix sorts, rank compare, 2/3-size recursion, induced SA0,
sample/non-sample merge) and its CPU gold (`sa_gold.cpp:42-110`).

This is the vectorized reference implementation (numpy): linear-time,
recursion on the 2/3 sample, merge via a cross-class comparator.  It
serves as (a) the DC3 algorithm capability itself and (b) an
independent O(n) oracle for the device prefix-doubling
`primitives.suffix.suffix_array`, which remains the device production
path (single compiled program; DC3's data-dependent recursion depth
would need ~log_{1.5}(n) separately compiled levels — SURVEY.md §7
hard part 1).
"""

from __future__ import annotations

import numpy as np


def dc3_suffix_array(data) -> np.ndarray:
    """Suffix array of uint8[n] via DC3."""
    s = np.asarray(data, np.int64) + 1  # symbols >= 1; 0 is the sentinel
    return _dc3(s)


def _dc3(s: np.ndarray) -> np.ndarray:
    n = len(s)
    if n <= 3:
        sufs = sorted(range(n), key=lambda i: tuple(s[i:]))
        return np.asarray(sufs, np.int64)
    t = np.concatenate([s, [0, 0, 0]])
    n0 = (n + 2) // 3
    n1 = (n + 1) // 3
    # pad with a dummy class-1 position when n % 3 == 1 so |class1| == n0
    ntot = n + (1 if n % 3 == 1 else 0)
    idx = np.arange(ntot)
    pos12 = idx[idx % 3 != 0]

    # radix sort of character triples
    order = np.lexsort((t[pos12 + 2], t[pos12 + 1], t[pos12]))
    sorted12 = pos12[order]
    trip = np.stack(
        [t[sorted12], t[sorted12 + 1], t[sorted12 + 2]], axis=1
    )
    new = np.concatenate(
        [[0], (trip[1:] != trip[:-1]).any(axis=1).astype(np.int64)]
    )
    names_sorted = np.cumsum(new)  # 0-based dense names in sorted order
    n_names = int(names_sorted[-1]) + 1

    if n_names < len(pos12):
        # recursion string: class-1 names then class-2 names, text order
        name_of = np.zeros(ntot + 3, np.int64)
        name_of[sorted12] = names_sorted + 1  # >= 1 for the recursion
        r1 = name_of[1:ntot:3]
        r2 = name_of[2:ntot:3]
        rec = np.concatenate([r1, r2])
        sa_rec = _dc3(rec)
        # map recursion indices back to text positions
        k1 = len(r1)
        sorted12 = np.where(
            sa_rec < k1, 1 + 3 * sa_rec, 2 + 3 * (sa_rec - k1)
        )
    # drop the dummy padding position (== n) if present
    sorted12 = sorted12[sorted12 < n]

    rank = np.zeros(n + 3, np.int64)  # rank among sample suffixes, >= 1
    rank[sorted12] = np.arange(1, len(sorted12) + 1)

    # SA0: class-0 positions induced-sorted by (char, rank of successor)
    pos0 = np.arange(0, n, 3)
    order0 = np.lexsort((rank[pos0 + 1], t[pos0]))
    sa0 = pos0[order0]

    # merge SA12 and SA0 with the cross-class comparator
    return _merge(t, rank, sorted12, sa0, n)


def _less12_0(t, rank, a, b):
    """Vectorized comparator: sample suffixes a vs class-0 suffixes b."""
    is1 = a % 3 == 1
    # class 1: (t[a], rank[a+1]) vs (t[b], rank[b+1])
    c1 = (t[a] < t[b]) | ((t[a] == t[b]) & (rank[a + 1] < rank[b + 1]))
    # class 2: (t[a], t[a+1], rank[a+2]) vs same for b
    c2 = (
        (t[a] < t[b])
        | ((t[a] == t[b]) & (t[a + 1] < t[b + 1]))
        | ((t[a] == t[b]) & (t[a + 1] == t[b + 1])
           & (rank[a + 2] < rank[b + 2]))
    )
    return np.where(is1, c1, c2)


def _merge(t, rank, sa12, sa0, n):
    """Merge the two sorted lists by binary-searching each element of
    sa12 into sa0 (count of sa0 elements less than it), vectorized."""
    n12, n0 = len(sa12), len(sa0)
    # for each a in sa12: how many b in sa0 with b < a
    lo = np.zeros(n12, np.int64)
    hi = np.full(n12, n0, np.int64)
    for _ in range(int(n0).bit_length() + 1):
        mid = (lo + hi) // 2
        midc = np.minimum(mid, n0 - 1)
        b = sa0[midc]
        # b < a  <=>  not (a <= b)  <=>  not less12_0(a,b) and not equal
        a_less = _less12_0(t, rank, sa12, b)
        take_hi = a_less | (mid >= n0)
        hi = np.where(take_hi, mid, hi)
        lo = np.where(take_hi, lo, mid + 1)
    cnt_less = lo  # number of sa0 elements strictly before each sa12 elem
    out = np.zeros(n, np.int64)
    pos12 = np.arange(n12) + cnt_less
    out[pos12] = sa12
    mask = np.ones(n, bool)
    mask[pos12] = False
    out[mask] = sa0
    return out
