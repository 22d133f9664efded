"""LZSS: the device codec vs the bit-exact C gold (lzss-0.6.2 compatible).

Interop matrix (the reference's own test strategy, SURVEY.md §4.5):
gold encode -> device decode, device encode -> gold decode, round trip,
and compressed size <= the reference encoder's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulc.codecs.lzss import driver
from tpulc.gold.lzss_gold import lzss_decode as gold_decode
from tpulc.gold.lzss_gold import lzss_encode as gold_encode


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


# every case is exactly CASE_LEN bytes so the jitted encoder/decoder
# compile once and are reused across the whole matrix
CASE_LEN = 10240


def _fit(b: bytes) -> bytes:
    return (b * (CASE_LEN // len(b) + 1))[:CASE_LEN]


CASES = {
    "text": lambda: _pg(CASE_LEN),
    "runs": lambda: _fit(b"abcabcabc"),
    "random": lambda: np.random.default_rng(3).integers(
        0, 256, size=CASE_LEN
    ).astype(np.uint8).tobytes(),
    "spaces": lambda: _fit(b"   leading spaces match the virtual window   "),
    "binary": lambda: _fit(bytes(range(256))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gold_encode_tpu_decode(name):
    data = CASES[name]()
    enc = gold_encode(data)
    dec = driver.decompress_raw(enc, len(data) + 64)
    assert dec == data


@pytest.mark.parametrize("name", sorted(CASES))
def test_tpu_encode_gold_decode(name):
    data = CASES[name]()
    enc = driver.compress_raw(data)
    dec = gold_decode(enc, len(data) + 64)
    assert dec == data


@pytest.mark.parametrize("name", sorted(CASES))
def test_tpu_roundtrip_and_size(name):
    data = CASES[name]()
    enc = driver.compress_raw(data)
    dec = driver.decompress_raw(enc, len(data) + 64)
    assert dec == data
    ref_size = len(gold_encode(data))
    assert len(enc) <= ref_size * 1.02 + 8, (len(enc), ref_size)


def test_container_roundtrip():
    data = _pg(65536)
    comp = driver.compress(data, block_size=65536)
    assert driver.decompress(comp) == data


def test_tiny_inputs():
    for data in (b"", b"a", b"ab", b"abc", b"hello world"):
        if data:
            enc = driver.compress_raw(data)
            assert driver.decompress_raw(enc, len(data) + 64) == data
        comp = driver.compress(data, block_size=4096)
        assert driver.decompress(comp) == data


def test_exact_mode_matches_reference_size():
    """exact=True reproduces brute.c longest-match lengths, so the
    greedy parse and compressed size equal the reference encoder's
    (BASELINE config 1 requires size <= reference)."""
    data = _pg(CASE_LEN)
    enc = driver.compress_raw(data, exact=True)
    ref = gold_encode(data)
    assert len(enc) == len(ref), (len(enc), len(ref))
    assert driver.decompress_raw(enc, len(data) + 64) == data
    assert gold_decode(enc, len(data) + 64) == data
