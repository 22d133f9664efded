"""ST-k sort transform: forward vs naive gold, inverse round trip."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulc.codecs.bwt.stk import st_decode, st_encode, st_encode_np


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return np.frombuffer(f.read()[:n], np.uint8)


CASES = {
    "text": lambda: _pg(12000),
    "random": lambda: np.random.default_rng(4).integers(
        0, 256, size=8000
    ).astype(np.uint8),
    "runs": lambda: np.frombuffer((b"abcabc" * 2000)[:9000], np.uint8),
    "tiny": lambda: np.frombuffer(b"banana", np.uint8),
    "binary": lambda: np.frombuffer(bytes(range(256)) * 20, np.uint8),
}


@pytest.mark.parametrize("k", [3, 4, 5, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_st_forward_matches_gold_and_roundtrips(name, k):
    arr = CASES[name]()
    last, idx0 = st_encode(jnp.asarray(arr), k=k)
    want_last, want_idx = st_encode_np(arr, k=k)
    np.testing.assert_array_equal(np.asarray(last), want_last)
    assert int(idx0) == want_idx
    back = st_decode(np.asarray(last), int(idx0), k=k)
    np.testing.assert_array_equal(back, arr)


def test_st_clusters_like_bwt():
    # bounded-context sorting should still cluster text for MTF
    from tpulc.primitives.mtf import mtf_encode

    arr = _pg(16384)
    last, _ = st_encode(jnp.asarray(arr), k=8)
    enc = np.asarray(mtf_encode(jnp.asarray(np.asarray(last))))
    assert (enc < 16).mean() > 0.75


@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("name", ["text", "runs", "tiny"])
def test_st_masked_matches_unmasked(name, k):
    """Masked ST at capacity > n equals exact-shape ST of the prefix."""
    from tpulc.codecs.bwt.stk import st_encode_masked

    arr = CASES[name]()
    n = arr.shape[0]
    cap = 16384
    padded = np.zeros(cap, np.uint8)
    padded[:n] = arr
    last_m, idx0_m = st_encode_masked(jnp.asarray(padded), jnp.int32(n), k=k)
    want_last, want_idx = st_encode_np(arr, k=k)
    np.testing.assert_array_equal(np.asarray(last_m)[:n], want_last)
    assert int(idx0_m) == want_idx
    back = st_decode(np.asarray(last_m)[:n], int(idx0_m), k=k)
    np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("k", [5, 8])
def test_st_context_keys_masked(k):
    """Masked context reconstruction equals the exact-shape one."""
    from tpulc.codecs.bwt.stk import st_context_keys, st_context_keys_masked

    arr = CASES["text"]()
    n = arr.shape[0]
    last, _ = st_encode(jnp.asarray(arr), k=k)
    cap = 16384
    padded = np.zeros(cap, np.uint8)
    padded[:n] = np.asarray(last)
    hi_m, lo_m = st_context_keys_masked(jnp.asarray(padded), jnp.int32(n), k=k)
    hi, lo = st_context_keys(last, k=k)
    np.testing.assert_array_equal(np.asarray(hi_m)[:n], np.asarray(hi))
    np.testing.assert_array_equal(np.asarray(lo_m)[:n], np.asarray(lo))


def test_st_device_decode_with_next_stream():
    """The wired next-char stream F makes inverse ST a static
    permutation (child/parent (k+1)-gram occurrences pair in position
    order): encode+decode fully on device must reproduce the input, for
    several k and content shapes, including idx0 != 0 and repetitive
    input."""
    import numpy as np
    import jax.numpy as jnp

    from tpulc.codecs.bwt.stk import (
        st_decode_device,
        st_encode,
        st_encode_with_next,
    )

    rng = np.random.default_rng(5)
    with open("tests/data/pg1661.txt", "rb") as f:
        text = np.frombuffer(f.read()[:20000], np.uint8)
    cases = [
        rng.integers(0, 4, 77).astype(np.uint8),
        rng.choice(np.frombuffer(b"the quick brown fox! ", np.uint8),
                   3000).astype(np.uint8),
        text,
        np.tile(np.frombuffer(b"abcabcab", np.uint8), 40),  # periodic
    ]
    for k in (3, 5, 8):
        for data in cases:
            last, fnext, idx0 = st_encode_with_next(jnp.asarray(data), k)
            l2, i2 = st_encode(jnp.asarray(data), k)
            assert np.array_equal(np.asarray(last), np.asarray(l2))
            assert int(idx0) == int(i2)
            out = np.asarray(st_decode_device(last, fnext, idx0, k))
            assert np.array_equal(out, data), (k, len(data))


@pytest.mark.parametrize("k", [3, 5, 8])
@pytest.mark.parametrize("name", ["text", "runs", "tiny", "random"])
def test_st_device_decode_masked(name, k):
    """Masked wired-F encode/decode at capacity > n round-trips and
    matches the exact-shape wired forward on the valid prefix."""
    from tpulc.codecs.bwt.stk import (
        st_decode_device_masked,
        st_encode_with_next,
        st_encode_with_next_masked,
    )

    arr = CASES[name]()
    n = arr.shape[0]
    cap = 16384
    padded = np.zeros(cap, np.uint8)
    padded[:n] = arr
    last_m, fnext_m, idx0_m = st_encode_with_next_masked(
        jnp.asarray(padded), jnp.int32(n), k=k)
    last, fnext, idx0 = st_encode_with_next(jnp.asarray(arr), k)
    np.testing.assert_array_equal(np.asarray(last_m)[:n], np.asarray(last))
    np.testing.assert_array_equal(np.asarray(fnext_m)[:n],
                                  np.asarray(fnext))
    assert int(idx0_m) == int(idx0)
    out = np.asarray(st_decode_device_masked(
        last_m, fnext_m, idx0_m, jnp.int32(n), k=k))
    np.testing.assert_array_equal(out[:n], arr)
