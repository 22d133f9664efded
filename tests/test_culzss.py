"""CULZSS packet codec: format gold interop + container round trip."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulc.codecs.lzss import culzss_driver
from tpulc.codecs.lzss.culzss import PCKT, culzss_encode_block
from tpulc.gold import culzss_gold


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


CASES = {
    "text": lambda: _pg(PCKT * 3),
    "runs": lambda: (b"\x00" * 500 + b"abcabc" * 200 + b"\xff" * 900) * 4,
    "random": lambda: np.random.default_rng(9).integers(
        0, 256, size=PCKT * 2
    ).astype(np.uint8).tobytes(),
    "single": lambda: b"z" * (PCKT * 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tpu_encode_gold_decode(name):
    """Every device-encoded packet must decode with the reference-semantics
    serial gold decoder (format validity)."""
    data = CASES[name]()[: PCKT * 2]
    data = data + bytes(PCKT * 2 - len(data))
    out, sizes, _ = culzss_encode_block(
        jnp.asarray(np.frombuffer(data, np.uint8))
    )
    out, sizes = np.asarray(out), np.asarray(sizes)
    for j in range(2):
        pbytes = out[j, : int(sizes[j])].tobytes()
        dec = culzss_gold.decode_packet(pbytes)
        assert dec == data[j * PCKT: (j + 1) * PCKT], name


def test_gold_encode_tpu_decode():
    """The device decoder handles arbitrary gold-encoded packets."""
    from tpulc.codecs.lzss.culzss import culzss_decode_block

    data = _pg(PCKT * 2)
    cap_out = PCKT + PCKT // 8 + 8
    pbuf = np.zeros((2, cap_out), np.uint8)
    psizes = np.zeros(2, np.int32)
    for j in range(2):
        enc = culzss_gold.encode_packet(data[j * PCKT: (j + 1) * PCKT])
        pbuf[j, : len(enc)] = np.frombuffer(enc, np.uint8)
        psizes[j] = len(enc)
    blocks, outl = culzss_decode_block(jnp.asarray(pbuf), jnp.asarray(psizes))
    got = np.asarray(blocks).reshape(-1).tobytes()
    assert got == data
    assert list(np.asarray(outl)) == [PCKT, PCKT]


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_roundtrip(name):
    data = CASES[name]()
    comp = culzss_driver.compress(data, block_size=PCKT * 2)
    assert culzss_driver.decompress(comp) == data


def test_compression_ratio():
    # A 128-byte window yields ~1.07 on book text even with the
    # reference's full-window search (verified against the serial
    # gold); the reference's 1.60 figure came from repetitive data.
    text = _pg(PCKT * 4)
    comp = culzss_driver.compress(text, block_size=PCKT * 4)
    assert len(text) / len(comp) > 1.03
    rep = (b"hello world, hello compression! " * 2048)[: PCKT * 4]
    comp = culzss_driver.compress(rep, block_size=PCKT * 4)
    assert len(rep) / len(comp) > 4.0


def test_incompressible_raw_fallback():
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, size=PCKT * 2).astype(np.uint8).tobytes()
    comp = culzss_driver.compress(data, block_size=PCKT * 2)
    assert culzss_driver.decompress(comp) == data
    # raw fallback keeps expansion bounded
    assert len(comp) < len(data) * 1.05


def test_beats_reference_encoder_semantics():
    """tpulc's full-window search must compress at least as well as a
    faithful simulation of the reference's own EncodeKernel/FindMatch/
    aftercomp (`gpu_compress.cu:104-350,462-569`) — the honest parity
    bar for this codec (the README's 1.60 is unreproducible; see
    PARITY.md §2.1 and tools/culzss_refsim.py)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import culzss_refsim as refsim

    data = _pg(PCKT * 2)
    data = data + bytes(PCKT * 2 - len(data))
    out, sizes, _ = culzss_encode_block(
        jnp.asarray(np.frombuffer(data, np.uint8))
    )
    sizes = np.asarray(sizes)
    for j in range(2):
        pkt = data[j * PCKT: (j + 1) * PCKT]
        ref_enc = refsim.aftercomp(refsim.encode_packet_pairs(pkt))
        # the reference's own output must decode (sanity of the sim)
        assert culzss_gold.decode_packet(ref_enc) == pkt
        assert int(sizes[j]) <= len(ref_enc)
