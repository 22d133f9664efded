"""Group-rank coder (bsc -e2 v3): core + driver round trips."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpulc.codecs.bsclike import grc


def _mk_ranks(n, seed=0, p_run=0.3, p_rank=0.5):
    rng = np.random.default_rng(seed)
    r = np.zeros(n, np.int32)
    i = 0
    while i < n:
        i += int(rng.geometric(p_run))
        if i < n:
            r[i] = int(np.clip(rng.geometric(p_rank), 1, 255))
            i += 1
    return r


CASES = [
    ("dense", dict(p_run=0.9, p_rank=0.3)),
    ("sparse", dict(p_run=0.05, p_rank=0.7)),
    ("mixed", dict(p_run=0.3, p_rank=0.5)),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_core_roundtrip(name, kw):
    cap, m = 4096, 3777
    ranks = _mk_ranks(cap, seed=hash(name) % 1000, **kw)
    ranks[m:] = 0
    maxbits = int(np.asarray(
        grc.grc_lane_bits(jnp.asarray(ranks), jnp.int32(m))[0]).max())
    W = grc_bucket(maxbits)
    words, counts, states, inits, cinits, tot = grc.grc_encode(
        jnp.asarray(ranks), jnp.int32(m), W)
    dec = grc.grc_decode(words, counts, states, jnp.int32(m),
                         jnp.asarray(np.asarray(inits)),
                         jnp.asarray(np.asarray(cinits)),
                         jnp.int32(maxbits), cap)
    assert np.array_equal(np.asarray(dec)[:m], ranks[:m]), name


def grc_bucket(maxbits):
    from tpulc.codecs.bsclike.rans_adaptive import bucket_bits

    return bucket_bits(max(maxbits, 1))


def test_stats_host_matches_device():
    cap, m = 4096, 3500
    ranks = _mk_ranks(cap, seed=7)
    ranks[m:] = 0
    o, t, co, ct, lb = grc.grc_stats(jnp.asarray(ranks), jnp.int32(m),
                                     4096)
    oh, th, coh, cth, mlb = grc.stats_host(ranks, m)
    assert np.array_equal(np.asarray(o), oh)
    assert np.array_equal(np.asarray(t), th)
    assert int(np.asarray(lb).max()) == mlb


def test_extreme_streams():
    cap = 2048
    for name, ranks in [
        ("allzero", np.zeros(cap, np.int32)),
        ("allmax", np.full(cap, 255, np.int32)),
        ("alternate", np.where(np.arange(cap) % 2 == 0, 1, 2)),
    ]:
        m = cap
        maxbits = int(np.asarray(
            grc.grc_lane_bits(jnp.asarray(ranks), jnp.int32(m))[0]).max())
        words, counts, states, inits, cinits, tot = grc.grc_encode(
            jnp.asarray(ranks), jnp.int32(m), grc_bucket(maxbits))
        dec = grc.grc_decode(words, counts, states, jnp.int32(m),
                             jnp.asarray(np.asarray(inits)),
                             jnp.asarray(np.asarray(cinits)),
                             jnp.int32(maxbits), cap)
        assert np.array_equal(np.asarray(dec)[:m], ranks[:m]), name


def test_driver_grc_roundtrip_and_corruption():
    from tpulc.codecs.bsclike import driver as D

    with open("tests/data/pg1661.txt", "rb") as f:
        text = f.read()[:50000]
    c2 = D.compress(text, block_size=65536, coder=2)
    assert D.decompress(c2) == text
    # coder-2 streams now carry the GRC payload (coder byte 4)
    from tpulc.pipeline.container import Container

    cc = Container.from_bytes(c2)
    coder_byte = cc.payloads[0][D._HEAD.size - 1]
    assert coder_byte in (D.CODER_GRC, D.CODER_STORED_SENTINEL) \
        if hasattr(D, "CODER_STORED_SENTINEL") else coder_byte == D.CODER_GRC
    bad = bytearray(c2)
    bad[len(bad) // 2] ^= 0x20
    with pytest.raises(Exception):
        D.decompress(bytes(bad))


def test_inits_pack_roundtrip():
    rng = np.random.default_rng(3)
    tot = (rng.random(grc.NM) < 0.2).astype(np.int64) * 5
    ones = (tot > 0) * 2
    inits = grc.quantize_inits(ones, tot)
    blob = grc.pack_inits(inits, tot)
    out, off = grc.unpack_inits(b"xx" + blob, 2)
    assert off == 2 + len(blob)
    assert np.array_equal(out[tot > 0], inits[tot > 0])
    assert (out[tot == 0] == grc.SCALE // 2).all()


@pytest.mark.parametrize("name,kw", CASES)
def test_start_bucket_roundtrip(name, kw):
    """Encode with the driver's compact start bucket (bs < cap) and
    decode back exactly, for each stream shape."""
    cap, m = 4096, 3777
    ranks = _mk_ranks(cap, seed=hash(name) % 1000, **kw)
    ranks[m:] = 0
    lane_bits, nstarts = grc.grc_lane_bits(jnp.asarray(ranks), jnp.int32(m))
    maxbits = int(np.asarray(lane_bits).max())
    bs = min(1 << max(10, (int(nstarts) - 1).bit_length()), cap)
    words, counts, states, inits, cinits, _ = grc.grc_encode(
        jnp.asarray(ranks), jnp.int32(m), grc_bucket(maxbits), bs=bs)
    dec = grc.grc_decode(words, counts, states, jnp.int32(m),
                         jnp.asarray(np.asarray(inits)),
                         jnp.asarray(np.asarray(cinits)),
                         jnp.int32(maxbits), cap)
    assert np.array_equal(np.asarray(dec)[:m], ranks[:m]), name


def test_binarize_bs_bucket_matches_full():
    """The compact-starts bucket (bs < cap) must produce the identical
    event grid and stream as the safe bs=cap default."""
    cap, m = 8192, 8000
    ranks = _mk_ranks(cap, seed=42, p_run=0.3, p_rank=0.5)
    ranks[m:] = 0
    lane_bits, nstarts_d = grc.grc_lane_bits(jnp.asarray(ranks),
                                             jnp.int32(m))
    maxbits = int(np.asarray(lane_bits).max())
    nstarts = int(np.asarray(nstarts_d))
    W = grc_bucket(maxbits)
    bs = 1 << max(10, (nstarts - 1).bit_length())
    assert bs < cap, (bs, nstarts)
    ref = grc.grc_encode(jnp.asarray(ranks), jnp.int32(m), W)
    got = grc.grc_encode(jnp.asarray(ranks), jnp.int32(m), W, bs=bs)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
