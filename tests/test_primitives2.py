"""Suffix array, parallel-primitive wrappers, autotune, filters."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulc.primitives import parallel as par
from tpulc.primitives.mtf import mtf_decode
from tpulc.primitives.suffix import sa_to_bwt, suffix_array, suffix_array_np


@pytest.mark.parametrize(
    "s", [b"banana", b"mississippi", b"aaaa", b"abcabc", b"x"]
)
def test_suffix_array_small(s):
    arr = np.frombuffer(s, np.uint8)
    got = np.asarray(suffix_array(jnp.asarray(arr)))
    np.testing.assert_array_equal(got, suffix_array_np(arr))


def test_suffix_array_random_and_text():
    rng = np.random.default_rng(11)
    for data in (
        rng.integers(0, 4, size=3000).astype(np.uint8),
        np.frombuffer(
            open("tests/data/pg1661.txt", "rb")
            .read()[:5000], np.uint8
        ),
    ):
        got = np.asarray(suffix_array(jnp.asarray(data)))
        np.testing.assert_array_equal(got, suffix_array_np(data))


def test_sa_to_bwt_matches_rotation_bwt_when_sentinel():
    # with a unique smallest sentinel, suffix order == rotation order
    from tpulc.codecs.bwt.rotsort import bwt_encode_np

    data = np.frombuffer(b"banana\x00", np.uint8)
    sa = suffix_array(jnp.asarray(data))
    bwt, idx0 = sa_to_bwt(jnp.asarray(data), sa)
    want, want_idx = bwt_encode_np(data)
    np.testing.assert_array_equal(np.asarray(bwt), want)
    assert int(idx0) == want_idx


def test_scans():
    x = jnp.asarray(np.array([3, 1, 4, 1, 5], np.int32))
    np.testing.assert_array_equal(np.asarray(par.scan(x)), [3, 4, 8, 9, 14])
    np.testing.assert_array_equal(
        np.asarray(par.scan(x, exclusive=True)), [0, 3, 4, 8, 9]
    )
    np.testing.assert_array_equal(
        np.asarray(par.scan(x, op=jnp.maximum)), [3, 3, 4, 4, 5]
    )
    np.testing.assert_array_equal(
        np.asarray(par.scan(x, reverse=True)), [14, 11, 10, 6, 5]
    )


def test_segmented_scan():
    x = jnp.asarray(np.array([1, 2, 3, 4, 5], np.int32))
    f = jnp.asarray(np.array([1, 0, 1, 0, 0], np.int32))
    np.testing.assert_array_equal(
        np.asarray(par.segmented_scan(x, f)), [1, 3, 3, 7, 12]
    )


def test_compact():
    x = jnp.asarray(np.array([9, 8, 7, 6], np.int32))
    m = jnp.asarray(np.array([True, False, True, False]))
    out, cnt = par.compact(x, m)
    assert int(cnt) == 2
    np.testing.assert_array_equal(np.asarray(out)[:2], [9, 7])


def test_sort_and_multisplit():
    k = jnp.asarray(np.array([3, 1, 3, 2], np.int32))
    v = jnp.asarray(np.array([0, 1, 2, 3], np.int32))
    ks, vs = par.sort_pairs(k, v)
    np.testing.assert_array_equal(np.asarray(vs), [1, 3, 0, 2])
    vals, starts = par.multisplit(v, k, 4)
    np.testing.assert_array_equal(np.asarray(starts), [0, 0, 1, 2])


def test_listrank_matches_ibwt_semantics():
    # simple 4-cycle: 0->2->1->3->0
    nxt = jnp.asarray(np.array([2, 3, 1, 0], np.int32))
    r = np.asarray(par.listrank(nxt, jnp.int32(0)))
    # rank = steps from head 0 to node: 0:0, 2:1, 1:2, 3:3
    np.testing.assert_array_equal(r, [0, 2, 1, 3])


def test_autotune_bounds():
    from tpulc.codecs.huffman.autotune import optimal_sub_bits

    assert optimal_sub_bits(0, 0, 12) == 128
    v = optimal_sub_bits(10_000_000, 2_000_000, 12)
    assert 128 <= v <= 4096 and v % 32 == 0


def test_filters_roundtrip():
    from tpulc.codecs.bsclike.filters import (
        block_reverse,
        record_reorder,
        record_reorder_inverse,
    )

    rng = np.random.default_rng(12)
    data = jnp.asarray(rng.integers(0, 256, size=1003).astype(np.uint8))
    for rs in (4, 16):
        fwd = record_reorder(data, rs)
        back = record_reorder_inverse(fwd, rs)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(data))
    np.testing.assert_array_equal(
        np.asarray(block_reverse(block_reverse(data))), np.asarray(data)
    )


def test_record_size_detector():
    from tpulc.codecs.bsclike.filters import detect_record_size

    rng = np.random.default_rng(13)
    # fixed-width 8-byte records: constant-ish fields -> strong lag-8
    recs = np.zeros((20000, 8), np.uint8)
    recs[:, 0] = 7
    recs[:, 1] = rng.integers(0, 3, 20000)
    recs[:, 2:4] = 255
    recs[:, 4:] = rng.integers(0, 256, (20000, 4))
    assert detect_record_size(recs.reshape(-1)) == 8
    # plain text: no stride structure
    with open("tests/data/pg1661.txt", "rb") as f:
        txt = np.frombuffer(f.read(300000), np.uint8)
    assert detect_record_size(txt) == 0
    # random: no structure
    assert detect_record_size(
        rng.integers(0, 256, 1 << 17).astype(np.uint8)
    ) == 0


def test_dc3_matches_naive_and_device():
    from tpulc.primitives.dc3 import dc3_suffix_array

    rng = np.random.default_rng(14)
    for data in (
        np.frombuffer(b"abracadabra", np.uint8),
        rng.integers(0, 3, size=2000).astype(np.uint8),
        np.frombuffer(
            open("tests/data/pg1661.txt", "rb")
            .read()[:4000], np.uint8
        ),
    ):
        want = suffix_array_np(data)
        np.testing.assert_array_equal(dc3_suffix_array(data), want)
        np.testing.assert_array_equal(
            np.asarray(suffix_array(jnp.asarray(data))), want
        )


def test_dc3_as_oracle_for_device_sa_large():
    """DC3 (O(n)) lets us cross-check the device SA at sizes where the
    naive gold would be quadratic-slow."""
    from tpulc.primitives.dc3 import dc3_suffix_array

    data = np.frombuffer(
        open("tests/data/pg1661.txt", "rb")
        .read()[:120000], np.uint8
    )
    np.testing.assert_array_equal(
        np.asarray(suffix_array(jnp.asarray(data))),
        dc3_suffix_array(data),
    )


def _mtf_decode_np(ranks):
    """Serial inverse MTF (the gold for arbitrary rank streams)."""
    table = list(range(256))
    out = np.empty(len(ranks), np.uint8)
    for i, r in enumerate(np.asarray(ranks)):
        sym = table.pop(int(r))
        table.insert(0, sym)
        out[i] = sym
    return out


@pytest.mark.parametrize("chunk", [64, 128])
def test_mtf_decode_arbitrary_ranks_matches_serial(chunk):
    """Inverse MTF of ranks that no encoder produced (any rank in
    0..255) equals the serial gold across many chunks: the per-chunk
    permutations and their composition scan carry the whole table."""
    rng = np.random.default_rng(15 + chunk)
    ranks = rng.integers(0, 256, size=16 * chunk).astype(np.uint8)
    got = np.asarray(mtf_decode(jnp.asarray(ranks), chunk=chunk))
    np.testing.assert_array_equal(got, _mtf_decode_np(ranks))


def test_suffix_array_dc3_device():
    """Device DC3 (one sample level + doubling) vs naive gold."""
    import numpy as np

    from tpulc.primitives.dc3_device import suffix_array_dc3
    from tpulc.primitives.suffix import suffix_array_np

    rng = np.random.default_rng(11)
    for n in (4, 5, 6, 7, 9, 64, 255, 1000, 1001, 1002):
        for alpha in (2, 256):
            data = rng.integers(0, alpha, n).astype(np.uint8)
            got = np.asarray(suffix_array_dc3(data))
            assert np.array_equal(got, suffix_array_np(data)), (n, alpha)
    # repetitive input (deep doubling inside the sample string)
    data = np.frombuffer(b"abcabcabcabc" * 40 + b"x", np.uint8)
    got = np.asarray(suffix_array_dc3(data))
    assert np.array_equal(got, suffix_array_np(data))


def test_sort_strings_full_matches_python():
    """Variable-length stringsort (cudppStringSort parity): suffix-rank
    ordering equals Python's sorted() on the same strings."""
    import numpy as np
    from tpulc.primitives.parallel import sort_strings_full

    rng = np.random.default_rng(33)
    words = [bytes(rng.integers(1, 256, rng.integers(1, 12)).tolist())
             for _ in range(40)]
    words += [b"abc", b"abcd", b"ab", b"abc"]  # prefixes + duplicate
    packed = b"\0".join(words) + b"\0"
    starts, off = [], 0
    for w in words:
        starts.append(off)
        off += len(w) + 1
    order = np.asarray(sort_strings_full(
        jnp.asarray(np.frombuffer(packed, np.uint8)),
        jnp.asarray(np.asarray(starts, np.int32)),
    ))
    got = [words[i] for i in order]
    assert got == sorted(words)


def test_orbit_flags():
    """Gather-only orbit enumeration vs a Python reference walk."""
    import numpy as np
    import jax.numpy as jnp

    from tpulc.primitives.parallel import orbit_flags

    rng = np.random.default_rng(5)
    n = 500
    jump = np.minimum(np.arange(n) + rng.integers(1, 9, n), n)
    jump_e = np.append(jump, n).astype(np.int32)
    got = np.asarray(orbit_flags(jnp.asarray(jump_e), n, n))
    ref = np.zeros(n, bool)
    p = 0
    while p < n:
        ref[p] = True
        p = int(jump_e[p])
    assert np.array_equal(got, ref)


def test_multi_scan():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 100, (5, 33)).astype(np.int32)
    got = np.asarray(par.multi_scan(jnp.asarray(x)))
    assert np.array_equal(got, np.cumsum(x, axis=1))
    got_ex = np.asarray(par.multi_scan(jnp.asarray(x), exclusive=True))
    ref_ex = np.concatenate(
        [np.zeros((5, 1), np.int32), np.cumsum(x, axis=1)[:, :-1]], axis=1)
    assert np.array_equal(got_ex, ref_ex)
    got_rev = np.asarray(par.multi_scan(jnp.asarray(x), op=jnp.maximum,
                                        reverse=True))
    ref_rev = np.maximum.accumulate(x[:, ::-1], axis=1)[:, ::-1]
    assert np.array_equal(got_rev, ref_rev)
    with pytest.raises(ValueError):
        par.multi_scan(jnp.asarray(x[0]))
