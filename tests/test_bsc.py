"""bsc-class codec: LZP + large-block pipeline round trips and ratio."""

import bz2

import numpy as np
import pytest

from tpulc.codecs.bsclike import driver
from tpulc.gold.lzp import lzp_decode, lzp_encode


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read()
    return (data * (n // len(data) + 1))[:n]


def test_lzp_roundtrip():
    base = _pg(150000)
    data = base + base  # long-range repeat, LZP's home turf
    enc = lzp_encode(data)
    assert enc is not None and len(enc) < len(data) // 2 + 2048
    assert lzp_decode(enc, len(data) + 64) == data


def test_lzp_incompressible_returns_none():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=50000).astype(np.uint8).tobytes()
    assert lzp_encode(data) is None


def test_bsc_roundtrip_repetitive():
    base = _pg(200000)
    data = base + base
    # needs one 512K block: the duplicate halves are 200KB apart, so
    # LZP only sees the repeat when both copies share a block
    comp = driver.compress(data, block_size=1 << 19)
    assert driver.decompress(comp) == data
    # repetitive corpus: LZP + block sorting must beat bzip2 -9
    assert len(comp) < len(bz2.compress(data, 9))


def test_bsc_roundtrip_random():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=200000).astype(np.uint8).tobytes()
    comp = driver.compress(data, block_size=1 << 18)
    assert driver.decompress(comp) == data
    assert len(comp) < len(data) * 1.05  # stored fallback bounds expansion


def test_bsc_small_inputs():
    for data in (b"", b"a", b"ab" * 40, _pg(100)):
        comp = driver.compress(data, block_size=1 << 16)
        assert driver.decompress(comp) == data


def test_bsc_multi_block():
    data = _pg(300000) * 3
    comp = driver.compress(data, block_size=1 << 18)
    assert driver.decompress(comp) == data


@pytest.mark.parametrize("sorter", ["st5", "st8"])
def test_bsc_st_sorter_roundtrip(sorter):
    """`-m st-k` mode: ST sorter recorded in the payload flags, decode
    dispatches the inverse-ST walk (libbsc's `-m` switch, bsc.cpp:85)."""
    data = _pg(120000)
    comp = driver.compress(data, block_size=1 << 17, sorter=sorter)
    assert driver.decompress(comp) == data
    # single-block driver path too
    blk = np.frombuffer(data[:60000], np.uint8)
    payload = driver.compress_block(blk, 1 << 16, sorter=sorter)
    out = driver.decompress_block(payload, 1 << 16)
    np.testing.assert_array_equal(out, blk)


def test_bsc_st_wired_roundtrip():
    """`-m st8w`: wired next-char stream makes the inverse ST fully
    device-resident (no ctypes on the decode path) at ~2x payload —
    the decode-parallelism trade libbsc cannot make (st.cpp:1029+)."""
    data = _pg(120000)
    comp = driver.compress(data, block_size=1 << 17, sorter="st8w")
    assert driver.decompress(comp) == data
    plain = driver.compress(data, block_size=1 << 17, sorter="st8")
    # priced: ~2-3x payload (the wired F stream clusters worse than
    # the last column under one shared MTF state)
    assert len(comp) < 3.0 * len(plain)
    # single-block driver path + wired flag recorded on the wire
    # (pg text at ~2.7x payload lands in the stored fallback, so the
    # flag check uses a strongly compressible block)
    blk = np.frombuffer((b"the quick brown fox jumps. " * 2300)[:60000],
                        np.uint8)
    payload = driver.compress_block(blk, 1 << 16, sorter="st8w",
                                    filter_mode="none")
    flags = payload[driver._HEAD.size - 2]
    assert driver._sorter_k_of_flags(flags) == (8, True)
    out = driver.decompress_block(payload, 1 << 16)
    np.testing.assert_array_equal(out, blk)
    # composes with -e2 (ABC coder) like the other ST modes
    c2 = driver.compress(data[:60000], block_size=1 << 16,
                         sorter="st8w", coder=2)
    assert driver.decompress(c2) == data[:60000]


def test_bsc_abc_coder_roundtrip():
    """`-e2` adaptive binary coder (QLFC-adaptivity parity): batch,
    single-block, multi-block, and tiny/degenerate inputs."""
    data = _pg(200000)
    comp = driver.compress(data, block_size=1 << 17, coder=2)
    assert driver.decompress(comp) == data
    blk = np.frombuffer(data[:60000], np.uint8)
    payload = driver.compress_block(blk, 1 << 16, coder=2)
    np.testing.assert_array_equal(
        driver.decompress_block(payload, 1 << 16), blk
    )
    for small in (b"", b"a", b"ab" * 40):
        comp = driver.compress(small, block_size=1 << 16, coder=2)
        assert driver.decompress(comp) == small


def test_bsc_abc_coder_random_and_ratio():
    """Random data survives (stored fallback); on text the adaptive
    coder must beat the static coder's size."""
    rng = np.random.default_rng(7)
    rnd = rng.integers(0, 256, size=120000).astype(np.uint8).tobytes()
    comp = driver.compress(rnd, block_size=1 << 17, coder=2)
    assert driver.decompress(comp) == rnd
    assert len(comp) < len(rnd) * 1.05
    text = _pg(250000)
    c1 = driver.compress(text, block_size=1 << 18, use_lzp=False)
    c2 = driver.compress(text, block_size=1 << 18, use_lzp=False, coder=2)
    assert driver.decompress(c2) == text
    assert len(c2) < len(c1), (len(c2), len(c1))


def test_bsc_abc_with_st_sorter():
    """Coder and sorter compose: -m st5 -e2."""
    data = _pg(90000)
    comp = driver.compress(data, block_size=1 << 17, sorter="st5", coder=2)
    assert driver.decompress(comp) == data


def _records(nrec=30000, width=8):
    rng = np.random.default_rng(21)
    recs = np.zeros((nrec, width), np.uint8)
    recs[:, 0] = 7
    recs[:, 1] = rng.integers(0, 3, nrec)
    recs[:, 2:4] = 255
    recs[:, 4] = (np.arange(nrec) // 256).astype(np.uint8)
    recs[:, 5] = (np.arange(nrec) % 256).astype(np.uint8)
    recs[:, 6:] = rng.integers(0, 16, (nrec, 2))
    return recs.reshape(-1).tobytes()


@pytest.mark.parametrize("mode", ["reverse", "reorder:8", "auto"])
def test_bsc_filter_roundtrip(mode):
    """--filter wiring (libbsc preprocessing parity): filter recorded
    per block, inverted on decode; batch and single-block paths."""
    data = _records()
    comp = driver.compress(data, block_size=1 << 18, filter_mode=mode)
    assert driver.decompress(comp) == data
    blk = np.frombuffer(data[:100000], np.uint8)
    payload = driver.compress_block(blk, 1 << 17, filter_mode=mode)
    np.testing.assert_array_equal(driver.decompress_block(payload, 1 << 17), blk)


def test_bsc_filter_reorder_ratio_win():
    """The reorder filter must actually pay on fixed-width records."""
    data = _records()
    plain = driver.compress(data, block_size=1 << 18, filter_mode="none")
    filt = driver.compress(data, block_size=1 << 18, filter_mode="auto")
    assert driver.decompress(filt) == data
    assert len(filt) < 0.97 * len(plain), (len(filt), len(plain))


def test_auto_segmentation_improves_mixed_ratio():
    """Entropy-model segmentation (detectors.cpp:70-290 role): a mixed
    random+text block must split under --filter auto, round trip, and
    compress smaller than the unsegmented coding (VERDICT r2 missing
    #3)."""
    import numpy as np

    from tpulc.codecs.bsclike import driver as D
    from tpulc.codecs.bsclike.filters import detect_segments

    rng = np.random.default_rng(3)
    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:30000]
    data = rng.integers(0, 256, 30000).astype(np.uint8).tobytes() + text
    segs = detect_segments(np.frombuffer(data, np.uint8))
    assert len(segs) > 1 and sum(segs) == len(data)
    c_none = D.compress(data, block_size=65536, filter_mode="none")
    c_auto = D.compress(data, block_size=65536, filter_mode="auto")
    assert D.decompress(c_auto) == data
    assert len(c_auto) < len(c_none)


def test_segmentation_leaves_homogeneous_alone():
    import numpy as np

    from tpulc.codecs.bsclike.filters import detect_segments

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:80000]
    assert detect_segments(np.frombuffer(text, np.uint8)) == [len(text)]


def test_e2_with_st_sorter_uses_abc_and_roundtrips():
    """-e2 on an ST sorter keeps the ABC coder (the GRC path needs the
    BWT rank stream); both must round trip."""
    from tpulc.codecs.bsclike import driver as D

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:40000]
    c = D.compress(text, block_size=65536, coder=2, sorter="st4")
    assert D.decompress(c) == text


def test_segmented_payload_hostile_sizes():
    import numpy as np
    import pytest

    from tpulc.codecs.bsclike import driver as D

    # build a segmented payload then corrupt the size table
    a = b"Qar" * 9000
    b = b"Qas" * 9000
    blk = np.frombuffer(a + b, np.uint8)
    p = D.compress_block(blk, 65536, filter_mode="auto")
    head = D._HEAD.unpack(p[: D._HEAD.size])
    if head[6] == D.CODER_SEGMENTED:
        bad = bytearray(p)
        bad[D._HEAD.size] ^= 0xFF  # first u32 segment size
        with pytest.raises(Exception):
            D.decompress_block(bytes(bad), 65536)


def test_auto_is_default_filter_mode():
    """r5: `--filter auto` IS the default — a mixed block segments
    without any flag, and the homogeneity pre-gate keeps uniform
    corpora on the batched path (VERDICT r4 next #9)."""
    import numpy as np

    from tpulc.codecs.bsclike import driver as D
    from tpulc.codecs.bsclike.filters import looks_heterogeneous

    rng = np.random.default_rng(3)
    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:30000]
    data = rng.integers(0, 256, 30000).astype(np.uint8).tobytes() + text
    c_default = D.compress(data, block_size=65536)
    c_none = D.compress(data, block_size=65536, filter_mode="none")
    assert D.decompress(c_default) == data
    assert len(c_default) < len(c_none)
    # gate: uniform text is NOT routed through the detector
    assert not looks_heterogeneous(
        np.frombuffer(text * 3, np.uint8))
