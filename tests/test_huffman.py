"""Huffman family: tables, device encode, parallel decode, driver e2e.

Test strategy follows the reference's gold-model pattern (SURVEY.md §4):
a slow numpy bit-serial codec is the oracle, plus Kraft/optimality
checks on the package-merge lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpulc.codecs.huffman import (
    HuffmanTable,
    canonical_codes,
    huffman_decode,
    huffman_encode,
    package_merge_lengths,
)
from tpulc.codecs.huffman import driver
from tpulc.codecs.huffman.tables import DEFAULT_MAX_LEN


def _ref_encode(data, codes, lengths):
    bits = "".join(f"{codes[b]:0{lengths[b]}b}" for b in data)
    return bits


def _ref_decode(bits, codes, lengths, n):
    inv = {}
    for s in np.flatnonzero(lengths):
        inv[f"{codes[s]:0{lengths[s]}b}"] = s
    out, cur = [], ""
    for ch in bits:
        cur += ch
        if cur in inv:
            out.append(inv[cur])
            cur = ""
            if len(out) == n:
                break
    return np.array(out, np.uint8)


def _rand_data(n, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        p = rng.dirichlet(np.full(256, 0.05))
        return rng.choice(256, size=n, p=p).astype(np.uint8)
    return rng.integers(0, 256, size=n).astype(np.uint8)


@pytest.mark.parametrize("skew", [False, True])
def test_package_merge_kraft_and_optimality(skew):
    data = _rand_data(20000, 7, skew)
    freqs = np.bincount(data, minlength=256)
    for L in (9, 12, 15):
        lengths = package_merge_lengths(freqs, L)
        assert lengths.max() <= L
        used = lengths[freqs > 0]
        assert (used > 0).all()
        assert (lengths[freqs == 0] == 0).all()
        kraft = np.sum(2.0 ** (-used.astype(np.float64)))
        assert kraft <= 1.0 + 1e-12
    # With a loose limit, total cost must be within 1% of entropy bound
    lengths = package_merge_lengths(freqs, 15)
    cost = int(np.sum(freqs * lengths))
    p = freqs[freqs > 0] / freqs.sum()
    entropy_bits = -np.sum(p * np.log2(p)) * freqs.sum()
    assert cost < entropy_bits * 1.03 + 8 * len(p)


def test_canonical_codes_prefix_free():
    freqs = np.bincount(_rand_data(5000, 8, skew=True), minlength=256)
    lengths = package_merge_lengths(freqs, 12)
    codes = canonical_codes(lengths)
    strs = [f"{codes[s]:0{lengths[s]}b}" for s in np.flatnonzero(lengths)]
    for i, a in enumerate(strs):
        for j, b in enumerate(strs):
            if i != j:
                assert not b.startswith(a)


@pytest.mark.parametrize("skew", [False, True])
def test_device_encode_matches_reference_bitstream(skew):
    data = _rand_data(3000, 9, skew)
    table = HuffmanTable.from_freqs(np.bincount(data, minlength=256), 12)
    bits = _ref_encode(data, table.codes, table.lengths)
    out_words = len(bits) // 32 + 2
    words, total = huffman_encode(
        jnp.asarray(data), jnp.asarray(table.codes),
        jnp.asarray(table.lengths), out_words,
    )
    assert int(total) == len(bits)
    got_bits = "".join(f"{int(w):032b}" for w in np.asarray(words))[: len(bits)]
    assert got_bits == bits


@pytest.mark.parametrize("sub_bits", [128, 512])
@pytest.mark.parametrize("skew", [False, True])
def test_selfsync_decode_roundtrip(skew, sub_bits):
    data = _rand_data(20000, 10, skew)
    table = HuffmanTable.from_freqs(np.bincount(data, minlength=256), 12)
    out_words = 20000 * 12 // 32 + 2
    words, total = huffman_encode(
        jnp.asarray(data), jnp.asarray(table.codes),
        jnp.asarray(table.lengths), out_words,
    )
    out, n_valid = huffman_decode(
        words, total, 20000 + 64,
        jnp.asarray(table.lut_sym), jnp.asarray(table.lut_len),
        12, sub_bits=sub_bits,
    )
    assert int(n_valid) == 20000
    np.testing.assert_array_equal(np.asarray(out)[:20000], data)


def test_decode_tiny_and_single_symbol():
    # degenerate: one distinct symbol
    data = np.full(100, 42, np.uint8)
    table = HuffmanTable.from_freqs(np.bincount(data, minlength=256), 12)
    words, total = huffman_encode(
        jnp.asarray(data), jnp.asarray(table.codes),
        jnp.asarray(table.lengths), 16,
    )
    out, n_valid = huffman_decode(
        words, total, 128, jnp.asarray(table.lut_sym),
        jnp.asarray(table.lut_len), 12,
    )
    assert int(n_valid) == 100
    np.testing.assert_array_equal(np.asarray(out)[:100], data)


@pytest.mark.parametrize("aligned", [True, False])
def test_driver_container_roundtrip(aligned):
    data = _rand_data(300000, 11, skew=True).tobytes()
    comp = driver.compress(data, block_size=1 << 17, aligned=aligned)
    back = driver.decompress(comp)
    assert back == data
    # skewed data must actually compress
    assert len(comp) < len(data)


def test_driver_roundtrip_text_like():
    text = (b"the quick brown fox jumps over the lazy dog. " * 3000)
    comp = driver.compress(text, block_size=1 << 16)
    assert driver.decompress(comp) == text
    assert len(comp) < len(text) * 0.7


def test_package_merge_device_matches_host():
    """Device PM (the bz fused-compress table build) is bit-identical
    to the host package-merge across distribution shapes."""
    import jax.numpy as jnp

    from tpulc.codecs.huffman.device_tables import (
        package_merge_lengths_device,
    )

    rng = np.random.default_rng(7)
    cases = [rng.integers(0, 1000, 257)]
    z = (rng.zipf(1.3, 257) * (rng.random(257) < 0.7)).astype(np.int64)
    while z.sum() > (1 << 25):
        z = z // 2
    cases.append(z)
    one = np.zeros(257, np.int64)
    one[100] = 5
    cases.append(one)
    skew = np.zeros(257, np.int64)
    skew[:3] = [1, 1, (1 << 25) - 2]
    cases.append(skew)
    cases.append(np.zeros(257, np.int64))
    for f in cases:
        for L in (11, 15):
            want = package_merge_lengths(f, L)
            got = np.asarray(
                package_merge_lengths_device(jnp.asarray(f.astype(np.int32)), L)
            )
            np.testing.assert_array_equal(want, got)


def test_v2_wire_roundtrip_chunks():
    """FLAG_ALIGNED2 (u16 delta offsets) round-trips at several chunk
    sizes, including blocks whose tail chunk is partial."""
    rng = np.random.default_rng(11)
    data = rng.choice(
        np.frombuffer(b"abcdefgh hello world", np.uint8), 150_001
    ).tobytes()
    for chunk in (64, 128, 256, 512):
        comp = driver.compress(data, block_size=1 << 16,
                               chunk_syms=chunk)
        assert driver.decompress(comp) == data, chunk
    # v1 absolute-offset wire still decodes
    comp1 = driver.compress(data, block_size=1 << 16, chunk_syms=256)
    assert driver.decompress(comp1) == data


def _pack_chunks(syms, tables, sel, chunk):
    """Numpy MSB-first encoder of `syms` in chunks of `chunk` symbols,
    chunk c coded with table sel[c] -> (words u32, chunk bit offsets,
    total bits)."""
    bits, offs = [], []
    for c in range(-(-len(syms) // chunk)):
        offs.append(len(bits))
        codes, lens = tables[sel[c]]
        for s in syms[c * chunk:(c + 1) * chunk]:
            code, ln = int(codes[s]), int(lens[s])
            bits.extend((code >> (ln - 1 - k)) & 1 for k in range(ln))
    total = len(bits)
    bits += [0] * (-len(bits) % 32)
    words = np.packbits(np.asarray(bits, np.uint8)).view(">u4")
    return words.astype(np.uint32), np.asarray(offs, np.int32), total


@pytest.mark.parametrize("chunk,K,max_len,n", [
    (128, 1, 12, 128 * 9),          # one table, whole chunks
    (64, 1, 12, 64 * 7 + 23),       # partial tail chunk
    (128, 3, 15, 128 * 8 + 77),     # bz-style per-chunk tables, tail
    (256, 2, 15, 256 * 3),
])
def test_walk_kernel_matches_xla_walk(chunk, K, max_len, n):
    """The chunk-walk kernel (interpret mode) decodes exactly what the
    XLA LUT walk decodes, for one or K per-chunk tables, two blocks
    back to back, and a partial tail chunk."""
    import jax

    from tpulc.codecs.huffman.decode import huffman_decode_uniform_packed
    from tpulc.codecs.huffman.device_tables import canonical_lut_packed
    from tpulc.codecs.huffman.pallas_decode import walk_chunks
    from tpulc.codecs.huffman.tables import HuffmanTable

    rng = np.random.default_rng(chunk + K + n)
    alpha = 257 if max_len == 15 else 256
    tables, lens_k = [], []
    for _ in range(K):
        freqs = rng.zipf(1.3, alpha) * (rng.random(alpha) < 0.8)
        freqs[rng.integers(alpha)] += 1
        t = HuffmanTable.from_freqs(freqs, max_len)
        tables.append((t.codes, t.lengths))
        lens_k.append(np.asarray(t.lengths, np.int32))
    luts = jax.vmap(lambda ln: canonical_lut_packed(ln, max_len))(
        jnp.asarray(np.stack(lens_k)))
    nsub = -(-n // chunk)
    blocks, want = [], []
    for b in range(2):
        sel = rng.integers(0, K, size=nsub)
        live = [np.flatnonzero(np.asarray(tables[k][1]) > 0)
                for k in range(K)]
        syms = np.concatenate([rng.choice(live[sel[c]], chunk)
                               for c in range(nsub)])[:n]
        words, offs, total = _pack_chunks(syms, tables, sel, chunk)
        lut_base = jnp.asarray(sel << max_len, jnp.int32)
        ref = huffman_decode_uniform_packed(
            jnp.asarray(np.append(words, np.zeros(4, np.uint32))),
            jnp.int32(total), nsub * chunk, luts.reshape(-1), max_len,
            jnp.asarray(offs), chunk, out_dtype=jnp.int32,
            lut_base=lut_base)
        np.testing.assert_array_equal(np.asarray(ref)[:n], syms)
        blocks.append((words, offs, total, sel))
        want.append(np.asarray(ref))
    w_pad = max(len(b[0]) for b in blocks) + 2
    flat = np.zeros(2 * w_pad, np.uint32)
    for b, (words, _, _, _) in enumerate(blocks):
        flat[b * w_pad: b * w_pad + len(words)] = words
    offs = np.concatenate([b[1] for b in blocks])
    ends = np.concatenate([np.append(b[1][1:], b[2]) for b in blocks])
    wbase = np.repeat(np.arange(2) * w_pad, nsub)
    sel = np.concatenate([b[3] for b in blocks])
    got = walk_chunks(jnp.asarray(flat), jnp.asarray(wbase),
                      jnp.asarray(offs), jnp.asarray(ends),
                      luts.reshape(-1), jnp.asarray(sel << max_len),
                      chunk, max_len, interpret=True)
    got = np.asarray(got).reshape(2, nsub * chunk)
    for b in range(2):
        np.testing.assert_array_equal(got[b][:n], want[b][:n])
        assert not got[b][n:].any()      # steps past the end bit hold 0


def _aligned_batch(seed=3, n=3 * 5000 + 1234, block=5000):
    rng = np.random.default_rng(seed)
    data = (rng.zipf(1.5, n) % 256).astype(np.uint8)
    comp = driver.compress(data.tobytes(), block_size=block)
    from tpulc.pipeline.container import Container

    c = Container.from_bytes(comp)
    return data, c, driver._parse_aligned_group(
        c.payloads, c.block_size, DEFAULT_MAX_LEN)


def test_batch_walk_matches_rank_decoder():
    """The huffman batch layout (one table per block, blocks back to
    back) through the kernel in interpret mode equals the XLA rank
    decoder on every valid symbol of a batch with a partial tail
    block."""
    data, c, (words, tbits, lens, offs, ns, chunk) = _aligned_batch()
    args = tuple(jnp.asarray(x) for x in (words, tbits, lens, offs))
    got = np.asarray(driver._decode_batch_walk(
        *args, chunk, DEFAULT_MAX_LEN, interpret=True))
    ref = np.asarray(driver._decode_batch_ranks(
        *args, chunk, DEFAULT_MAX_LEN))
    assert got.shape == ref.shape
    start = 0
    for j, nj in enumerate(ns):
        np.testing.assert_array_equal(got[j, :nj], ref[j, :nj])
        np.testing.assert_array_equal(got[j, :nj],
                                      data[start: start + nj])
        start += nj


@pytest.mark.gpu
def test_batch_walk_compiled_matches_rank_decoder():
    """The kernel as compiled for the GPU equals the XLA rank decoder."""
    data, c, (words, tbits, lens, offs, ns, chunk) = _aligned_batch()
    args = tuple(jnp.asarray(x) for x in (words, tbits, lens, offs))
    got = np.asarray(driver._decode_batch_walk(*args, chunk,
                                               DEFAULT_MAX_LEN))
    ref = np.asarray(driver._decode_batch_ranks(*args, chunk,
                                                DEFAULT_MAX_LEN))
    for j, nj in enumerate(ns):
        np.testing.assert_array_equal(got[j, :nj], ref[j, :nj])


def test_odd_chunk_rejected():
    with pytest.raises(ValueError):
        driver.compress(b"abc" * 100, block_size=1024, chunk_syms=63)
