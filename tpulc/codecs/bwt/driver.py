"""bz codec driver: BWT -> MTF -> RLE2 -> canonical Huffman per block.

The tpulc equivalent of `cudppCompress`'s device-resident pipeline
(`compress_app.cu:507-526`: BWT, MTF, Huffman) extended with bzip2's
zero-run stage (`compress.c:123-240`), in tpulc's own container (the
bit-exact `.bz2` emitter is a separate codec).  Compress runs as ONE
fused device program per block — transform, multi-table refinement,
device package-merge table build and entropy encode — matching the
reference's single dispatch; the host only pulls the meta row and a
tight bucket of stream words.

Per-block payload (little-endian):

    n           u32   raw bytes in this block (<= cap, zero-padded)
    m           u32   RLE2 symbol count
    idx0        u32   BWT primary index
    total_bits  u32   entropy-stream bits
    mode        u8    bit0: decode anchors present
    lengths     129B  257 code lengths, nibble-packed
    nchunks     u32
    offset0     u32   absolute bit offset of chunk 0
    deltas      11-bit-packed * (nchunks-1)   per-chunk bit-size deltas
                      (a CHUNK_SYMS-symbol chunk is <= CHUNK_SYMS*15 =
                      1920 < 2^11 bits)
    [n_anchors  u32 + anchors 20-bit-packed (5B/pair)   when mode&1]
    words       4B * ceil(total_bits/32)
"""

from __future__ import annotations

import struct
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpulc.codecs.bwt.rle import ALPHABET, rle2_decode, rle2_encode
from tpulc.codecs.bwt.rotsort import (
    bwt_decode,
    bwt_decode_anchored,
    bwt_encode_anchored,
)
from tpulc.codecs.huffman.decode import (
    huffman_decode_uniform,
    huffman_decode_uniform_packed,
)
from tpulc.codecs.huffman.device_tables import canonical_lut_packed
from tpulc.codecs.huffman.pallas_decode import walk_chunks
from tpulc.codecs.huffman.tables import HuffmanTable
from tpulc.pipeline.container import Container
from tpulc.pipeline.registry import CODEC_BZ
from tpulc.primitives.bits import pack_bits
from tpulc.primitives.checksum import adler32_np
from tpulc.primitives.mtf import mtf_encode, mtf_decode
from tpulc.utils import timing
from tpulc.utils.backend import on_gpu

MAX_LEN = 15


# 128-symbol chunks halve the serial decode trip count vs 256; the
# offsets table ships as 11-bit-packed per-chunk deltas.
CHUNK_SYMS = 128
_BLOCK_HEAD = struct.Struct("<IIIIB")
_NIBBLES = (ALPHABET + 1) // 2 + ((ALPHABET + 1) % 2)  # 129 bytes


def _cap_for(block_size: int) -> int:
    return -(-block_size // 256) * 256  # MTF-chunk and CHUNK_SYMS multiple


ANCHOR_BITS = 20  # anchors are row indices < cap <= 2^20
DELTA_BITS = 11   # chunk bit-size < CHUNK_SYMS * MAX_LEN = 1920 < 2^11
SEL_BITS = 3      # table count K <= 6


def _pack_fields_np(vals: np.ndarray, width: int) -> bytes:
    """uint values (< 2^width) -> MSB-first bit-packed bytes."""
    v = vals.astype(np.uint32)
    bits = (
        (v[:, None] >> np.arange(width - 1, -1, -1, dtype=np.uint32)) & 1
    ).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _unpack_fields_np(buf: bytes, width: int, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros(0, np.int64)
    bits = np.unpackbits(
        np.frombuffer(buf, np.uint8), count=count * width
    ).reshape(count, width).astype(np.uint32)
    w = np.arange(width - 1, -1, -1, dtype=np.uint32)
    return (bits << w).sum(axis=1).astype(np.int64)


def _fields_bytes(count: int, width: int) -> int:
    return -(-count * width // 8)


def _pack_anchors(a: np.ndarray) -> bytes:
    """uint32[R] (values < 2^20) -> ceil(R/2)*5 bytes (two per 40 bits)."""
    v = a.astype(np.uint64)
    if v.shape[0] % 2:
        v = np.concatenate([v, np.zeros(1, np.uint64)])
    pairs = v[0::2] | (v[1::2] << np.uint64(ANCHOR_BITS))
    return pairs.view(np.uint8).reshape(-1, 8)[:, :5].tobytes()


def _unpack_anchors(buf: bytes, R: int) -> np.ndarray:
    rows = np.frombuffer(buf, np.uint8).reshape(-1, 5)
    full = np.zeros((rows.shape[0], 8), np.uint8)
    full[:, :5] = rows
    pairs = full.view(np.uint64).reshape(-1)
    mask = np.uint64((1 << ANCHOR_BITS) - 1)
    out = np.empty(rows.shape[0] * 2, np.int32)
    out[0::2] = (pairs & mask).astype(np.int32)
    out[1::2] = ((pairs >> np.uint64(ANCHOR_BITS)) & mask).astype(np.int32)
    return out[:R]


def _anchor_bytes(R: int) -> int:
    return -(-R // 2) * 5


# 512-step lane walks halve the inverse-BWT serial depth vs 1024; the
# extra anchor metadata (~0.4% of a typical block payload) still passes
# the encoder's anchors-vs-stream pricing.
ANCHOR_STRIDE = 512


@jax.jit
def _forward(block):
    """block uint8[cap] -> (syms, m, idx0, hist, anchors, anchors_ok)."""
    last, idx0, anchors, ok = bwt_encode_anchored(block, ANCHOR_STRIDE)
    ranks = mtf_encode(last)
    syms, m = rle2_encode(ranks)
    cap = block.shape[0]
    masked = jnp.where(jnp.arange(cap, dtype=jnp.int32) < m, syms, ALPHABET)
    # Histogram via sort + binary-searched bucket edges (a sort and a
    # 258-point searchsorted instead of a 1M-element scatter-add).
    s_sorted = jax.lax.sort((masked,), num_keys=1)[0]
    edges = jnp.searchsorted(
        s_sorted, jnp.arange(ALPHABET + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    hist = jnp.diff(edges)
    return syms, m, idx0, hist, anchors, ok







def _entropy_mt_core(syms, m, sel, codes, lengths, out_words: int,
                     nchunks: int):
    """Shared multi-table entropy body: codes/lengths [K, ALPHABET],
    chunk c's symbols use table sel[c].  Returns (words, total_bits,
    chunk_offsets)."""
    cap = syms.shape[0]
    K = codes.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < m
    packed_tab = ((codes.astype(jnp.int32) << 4) | lengths).astype(
        jnp.float32
    )  # [K, A]
    # one contraction gives every symbol's entry under EVERY table;
    # the per-chunk selector then picks a column (vector selects, no
    # gathers).
    oh = jax.nn.one_hot(syms, packed_tab.shape[1], dtype=jnp.float32)
    per_k = jnp.matmul(  # [cap, K]; exact — see _entropy
        oh, packed_tab.T, precision=jax.lax.Precision.HIGHEST
    )
    ctx = jnp.broadcast_to(
        sel[:cap // CHUNK_SYMS, None], (cap // CHUNK_SYMS, CHUNK_SYMS)
    ).reshape(cap)
    packed = jnp.zeros((cap,), jnp.float32)
    for k in range(K):
        packed = jnp.where(ctx == k, per_k[:, k], packed)
    packed = packed.astype(jnp.int32)
    sym_lens = jnp.where(valid, packed & 15, 0)
    sym_codes = jnp.where(valid, packed >> 4, 0).astype(jnp.uint32)
    words, total_bits = pack_bits(sym_codes, sym_lens, out_words)
    off = jnp.cumsum(sym_lens) - sym_lens
    chunk_offsets = off.reshape(-1, CHUNK_SYMS)[:nchunks, 0].astype(jnp.int32)
    chunk_valid = (jnp.arange(nchunks, dtype=jnp.int32) * CHUNK_SYMS) < m
    chunk_offsets = jnp.where(chunk_valid, chunk_offsets, total_bits)
    return words, total_bits, chunk_offsets


@partial(jax.jit, static_argnames=("anchor_count", "K", "out_words",
                                   "nchunks"))
def _compress_fused(block, anchor_count: int, K: int, out_words: int,
                    nchunks: int):
    """The WHOLE bz compress forward as one device program — transform,
    multi-table refinement, device package-merge, canonical codes and
    entropy encode (the `compress_app.cu:507-526` single-dispatch shape;
    round-1 compress bounced histograms to the host for table build,
    costing a D2H+H2D chain per block).

    Returns (meta int32, words uint32[out_words]); meta layout:

        [0] m  [1] idx0  [2] ok  [3] use_mt  [4] total_bits
        [5 : 5+K*A]   K tables' code lengths (single-table mode: table
                      0 = whole-block lengths, others zero)
        [+R]          decode anchors
        [+nchunks]    effective per-chunk selectors (zeros when !use_mt)
        [+nchunks]    chunk bit offsets
    """
    from tpulc.codecs.bwt.multitable import refine_tables
    from tpulc.codecs.huffman.device_tables import (
        canonical_codes_device,
        package_merge_lengths_device,
    )

    syms, m, idx0, hist, anchors, ok = _forward(block)
    del hist
    sel, clhist = refine_tables(syms, m, CHUNK_SYMS, K)
    hist_all = clhist.sum(axis=0)
    lens_mt = jax.vmap(
        lambda h: package_merge_lengths_device(h, MAX_LEN)
    )(clhist)
    lens_single = package_merge_lengths_device(hist_all, MAX_LEN)
    tb_mt = jnp.sum(clhist * lens_mt)
    tb_single = jnp.sum(hist_all * lens_single)
    used_chunks = jnp.maximum(-(-m // CHUNK_SYMS), 1)
    chunk_live = (jnp.arange(nchunks, dtype=jnp.int32) * CHUNK_SYMS) < m
    tab_used = jnp.zeros((K,), jnp.int32).at[
        jnp.where(chunk_live, sel[:nchunks], 0)
    ].max(jnp.where(chunk_live, 1, 0))
    n_used = tab_used.sum()
    # exact host pricing: K byte + extra length tables + selectors
    extra_bits = 8 * (
        1 + (n_used - 1) * _NIBBLES + (used_chunks * SEL_BITS + 7) // 8
    )
    use_mt = ok & (n_used >= 2) & (tb_mt + extra_bits < tb_single)
    lens_eff = jnp.where(
        use_mt,
        lens_mt,
        jnp.concatenate([lens_single[None], jnp.zeros((K - 1, ALPHABET),
                                                      jnp.int32)]),
    )
    sel_eff = jnp.where(use_mt, sel[:nchunks], 0)
    codes_eff, _ = jax.vmap(
        lambda ln: canonical_codes_device(ln, MAX_LEN)
    )(lens_eff)
    words, total_bits, chunk_offsets = _entropy_mt_core(
        syms, m, sel_eff, codes_eff, lens_eff, out_words, nchunks
    )
    meta = jnp.concatenate([
        jnp.stack([m, idx0, ok.astype(jnp.int32),
                   use_mt.astype(jnp.int32), total_bits]),
        lens_eff.reshape(-1),
        anchors[:anchor_count],
        sel_eff,
        chunk_offsets,
    ])
    return meta, words


@partial(jax.jit, static_argnames=("take",))
def _take_words(words, take: int):
    """Truncate the padded entropy stream to a power-of-two bucket for
    a tight D2H pull (compiled once per bucket size)."""
    return words[:take]


@partial(jax.jit, static_argnames=("out_words", "nchunks"))
def _entropy(syms, m, codes, lengths, out_words: int, nchunks: int):
    cap = syms.shape[0]
    valid = jnp.arange(cap, dtype=jnp.int32) < m
    # (code, len) ride one packed table looked up via one-hot matmul
    # (values < 2^19 are exact in f32).
    packed_tab = ((codes.astype(jnp.int32) << 4) | lengths).astype(
        jnp.float32
    )
    oh = jax.nn.one_hot(syms, packed_tab.shape[0], dtype=jnp.float32)
    # precision='highest': the GPU's default float32 matmul may run in
    # TF32, which would round the packed 19-bit table entries
    packed = jnp.matmul(
        oh, packed_tab, precision=jax.lax.Precision.HIGHEST
    ).astype(jnp.int32)
    sym_lens = jnp.where(valid, packed & 15, 0)
    sym_codes = jnp.where(valid, packed >> 4, 0).astype(jnp.uint32)
    words, total_bits = pack_bits(sym_codes, sym_lens, out_words)
    off = jnp.cumsum(sym_lens) - sym_lens
    # cap is a CHUNK_SYMS multiple: reshape beats a strided gather
    chunk_offsets = off.reshape(-1, CHUNK_SYMS)[:nchunks, 0].astype(jnp.int32)
    chunk_valid = (jnp.arange(nchunks, dtype=jnp.int32) * CHUNK_SYMS) < m
    chunk_offsets = jnp.where(chunk_valid, chunk_offsets, total_bits)
    return words, total_bits, chunk_offsets


@partial(jax.jit, static_argnames=("cap",))
def _inverse(words, total_bits, m, idx0, lut_sym, lut_len, offs, cap: int):
    syms = huffman_decode_uniform(
        words, total_bits, cap, lut_sym, lut_len, MAX_LEN,
        offs, CHUNK_SYMS, out_dtype=jnp.int32,
    )
    ranks, _ = rle2_decode(syms, m)
    last = mtf_decode(ranks)
    return bwt_decode(last, idx0)


@partial(jax.jit, static_argnames=("cap", "w_pad", "K"))
def _inverse_packed(row, cap: int, w_pad: int, K: int = 1):
    """Anchored inverse of one block from a single packed uint32 row:

        [0] total_bits  [1] m  [2] idx0  [3] flags
        [4 : 4+K*65]     K tables' 257 code lengths as bytes (u32 LE)
        [+sc]            per-chunk table selectors, u8 packed (sc =
                         ceil(ccap/4) words; all-zero when K == 1)
        [+ccap]          chunk bit offsets
        [+R]             decode anchors
        [+w_pad]         entropy stream words

    The whole batch ships as ONE uint32 H2D put; the K 2^MAX_LEN decode
    LUTs are rebuilt on device from the lengths (257 bytes each instead
    of 128 KB).  The GPU walks the chunks with the one-thread-per-chunk
    kernel (`pallas_decode.walk_chunks`); the CPU runs the same walk as
    an XLA loop over steps."""
    ccap = max(1, -(-cap // CHUNK_SYMS))
    R = -(-cap // ANCHOR_STRIDE)
    sc = -(-ccap // 4)
    total_bits = row[0].astype(jnp.int32)
    m = row[1].astype(jnp.int32)
    o = 4
    lens_u8 = jax.lax.bitcast_convert_type(
        row[o: o + K * 65], jnp.uint8
    ).reshape(K, 260)
    lengths = lens_u8[:, :ALPHABET].astype(jnp.int32)
    o += K * 65
    sel = jax.lax.bitcast_convert_type(
        row[o: o + sc], jnp.uint8
    ).reshape(-1)[:ccap].astype(jnp.int32)
    o += sc
    offs = row[o: o + ccap].astype(jnp.int32)
    o += ccap
    anchors = row[o: o + R].astype(jnp.int32)
    o += R
    words = row[o: o + w_pad]
    luts = jax.vmap(
        lambda ln: canonical_lut_packed(ln, MAX_LEN)
    )(lengths)  # [K, 2^L]
    lut_base = jnp.zeros_like(sel) if K == 1 else sel << MAX_LEN
    if on_gpu():
        ends = jnp.concatenate([offs[1:], total_bits[None]])
        syms = walk_chunks(
            jnp.concatenate([words, jnp.zeros((2,), jnp.uint32)]),
            jnp.zeros_like(offs), offs, ends, luts.reshape(-1), lut_base,
            CHUNK_SYMS, MAX_LEN,
        ).reshape(-1)[:cap]
    else:
        syms = huffman_decode_uniform_packed(
            words, total_bits, cap, luts.reshape(-1), MAX_LEN,
            offs, CHUNK_SYMS, out_dtype=jnp.int32,
            lut_base=None if K == 1 else lut_base,
        )
    ranks, _ = rle2_decode(syms, m)
    last = mtf_decode(ranks)
    return bwt_decode_anchored(last, anchors[0], anchors, ANCHOR_STRIDE)


def compress_block(block: np.ndarray, block_cap: int) -> bytes:
    n = block.shape[0]
    cap = _cap_for(block_cap)
    assert n <= cap
    padded = np.zeros(cap, np.uint8)
    padded[:n] = block
    syms, m, idx0, hist, anchors, ok = _forward(jnp.asarray(padded))
    table = HuffmanTable.from_freqs(np.asarray(hist), MAX_LEN)
    out_words = -(-cap * MAX_LEN // 32)
    nchunks = max(1, -(-cap // CHUNK_SYMS))
    words, total_bits, chunk_offsets = _entropy(
        syms, m, jnp.asarray(table.codes), jnp.asarray(table.lengths),
        out_words, nchunks,
    )
    m, idx0, total_bits = int(m), int(idx0), int(total_bits)
    nw = -(-total_bits // 32)
    lens = np.asarray(table.lengths, np.uint8)
    lens_pad = np.zeros(_NIBBLES * 2, np.uint8)
    lens_pad[:ALPHABET] = lens
    nibbles = (lens_pad[0::2] | (lens_pad[1::2] << 4)).tobytes()
    used_chunks = max(1, -(-m // CHUNK_SYMS))
    offs = np.asarray(chunk_offsets[:used_chunks]).astype(np.int64)
    # anchors pay off only when they are a sliver of the payload
    mode = 1 if (bool(ok) and
                 _anchor_bytes(int(np.asarray(anchors).shape[0])) * 20
                 < nw * 4) else 0
    payload = _BLOCK_HEAD.pack(n, m, idx0, total_bits, mode) + nibbles
    payload += struct.pack("<I", used_chunks)
    payload += struct.pack("<I", int(offs[0]))
    payload += _pack_fields_np(np.diff(offs), DELTA_BITS)
    if mode & 1:
        a = np.asarray(anchors).astype(np.uint32)
        payload += struct.pack("<I", a.shape[0]) + _pack_anchors(a)
    payload += np.asarray(words[:nw]).astype("<u4").tobytes()
    return payload


def _unpack_nibbles(nib: np.ndarray) -> np.ndarray:
    lengths = np.zeros(_NIBBLES * 2, np.int32)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    return lengths[:ALPHABET]


def _parse_block(payload: bytes):
    """-> (n, m, idx0, total_bits, lengths [K, ALPHABET], sel, bit_offsets,
    anchors, words); sel is None for single-table blocks."""
    n, m, idx0, total_bits, mode = _BLOCK_HEAD.unpack(
        payload[: _BLOCK_HEAD.size]
    )
    off = _BLOCK_HEAD.size
    if mode & 2:
        K = payload[off]
        off += 1
    else:
        K = 1
    lengths = np.zeros((K, ALPHABET), np.int32)
    for k in range(K):
        nib = np.frombuffer(payload[off: off + _NIBBLES], np.uint8)
        lengths[k] = _unpack_nibbles(nib)
        off += _NIBBLES
    (nchunks,) = struct.unpack("<I", payload[off: off + 4])
    off += 4
    (off0,) = struct.unpack("<I", payload[off: off + 4])
    off += 4
    db = _fields_bytes(nchunks - 1, DELTA_BITS)
    deltas = _unpack_fields_np(payload[off: off + db], DELTA_BITS,
                               nchunks - 1)
    off += db
    bit_offsets = (
        off0 + np.concatenate([[0], np.cumsum(deltas)])
    ).astype(np.int32)
    sel = None
    if mode & 2:
        sb = _fields_bytes(nchunks, SEL_BITS)
        sel = _unpack_fields_np(payload[off: off + sb], SEL_BITS,
                                nchunks).astype(np.uint8)
        off += sb
    anchors = None
    if mode & 1:
        (na,) = struct.unpack("<I", payload[off: off + 4])
        off += 4
        ab = _anchor_bytes(na)
        anchors = _unpack_anchors(payload[off: off + ab], na)
        off += ab
    nw = -(-total_bits // 32)
    words = np.frombuffer(payload[off: off + 4 * nw], "<u4")
    return n, m, idx0, total_bits, lengths, sel, bit_offsets, anchors, words


def decompress_block(payload: bytes, block_cap: int) -> np.ndarray:
    cap = _cap_for(block_cap)
    fast = _decompress_batch_packed([payload], cap)
    if fast is not None:
        return fast[0]
    n, m, idx0, total_bits, lengths, sel, bit_offsets, anchors, words = \
        _parse_block(payload)
    assert sel is None, "multi-table blocks always carry anchors"
    wcap = -(-cap * MAX_LEN // 32)
    words_p = np.zeros(wcap, np.uint32)
    words_p[: words.shape[0]] = words
    ccap = max(1, -(-cap // CHUNK_SYMS))
    offs_p = np.full(ccap, total_bits, np.int32)
    offs_p[: bit_offsets.shape[0]] = bit_offsets
    table = HuffmanTable.from_lengths(lengths[0], MAX_LEN)
    args = (
        jnp.asarray(words_p), jnp.int32(total_bits), jnp.int32(m),
        jnp.int32(idx0), jnp.asarray(table.lut_sym),
        jnp.asarray(table.lut_len), jnp.asarray(offs_p),
    )
    block = _inverse(*args, cap)
    return np.asarray(block[:n])


# The forward transform vmapped over a batch of blocks (the sharded
# programs' single-device reference in tests).
_forward_batch = jax.jit(jax.vmap(_forward))

MAX_BATCH = 16  # blocks per device round (bounds HBM working set)

_BUCKET0 = 4096  # minimum D2H word-pull granularity (16 KiB)

def _bucket_words(nw: int, out_words: int) -> int:
    """Round a word count up to a power-of-two bucket (bounds the set of
    compiled truncation programs and keeps pulls tight)."""
    b = _BUCKET0
    while b < nw:
        b *= 2
    return min(b, out_words)


def _encode_payloads(blocks: np.ndarray, ns: list[int]) -> list[bytes]:
    """blocks uint8[B, cap] (zero-padded), ns true sizes -> payloads.

    Blocks are dispatched sequentially, one program each: the vmapped
    batch would run its multi-operand sorts batched, and a block's
    program is large enough that dispatch overhead is small beside it.

    Compress is ONE fused device program per block (`_compress_fused`:
    transform + refinement + device package-merge + entropy, the
    `compress_app.cu:507-526` single-dispatch shape).  The host only
    pulls the packed meta row, then a power-of-two bucket of the
    stream words — no table build on the critical path.
    """
    B, cap = blocks.shape
    R = -(-cap // ANCHOR_STRIDE)
    K = 6  # one compiled refinement; unused tables stay empty
    nchunks = max(1, -(-cap // CHUNK_SYMS))
    out_words = -(-cap * MAX_LEN // 32)
    # per-block put immediately followed by its dispatch: block b+1's
    # upload overlaps block b's transform
    with timing.stage("bz.forward"):
        per = [_compress_fused(jnp.asarray(blocks[b]), R, K, out_words,
                               nchunks) for b in range(B)]

    # Each block's meta row is pulled first and its word bucket second,
    # both as async copies, so device compute for later blocks
    # proceeds under the earlier pulls.
    def encode_one(b: int, mt_row, ent) -> bytes:
        """Serialize block b from its (already pulled) meta row and
        word bucket."""
        m, idx0, ok, use_mt, tb = (
            int(mt_row[0]), int(mt_row[1]), bool(mt_row[2]),
            bool(mt_row[3]), int(mt_row[4]),
        )
        o = 5
        lens_eff = mt_row[o: o + K * ALPHABET].reshape(K, ALPHABET)
        o += K * ALPHABET
        anchors = mt_row[o: o + R]
        o += R
        sels = mt_row[o: o + nchunks].astype(np.uint8)
        o += nchunks
        offs_all = mt_row[o: o + nchunks]
        used_chunks = max(1, -(-m // CHUNK_SYMS))
        nw = -(-tb // 32)
        if use_mt:
            used_tabs = np.unique(sels[:used_chunks])
            remap = np.zeros(K, np.uint8)
            remap[used_tabs] = np.arange(len(used_tabs), dtype=np.uint8)
            lens = lens_eff[used_tabs]
        else:
            remap = None
            lens = lens_eff[:1]
        nibbles = b""
        for lk in lens:
            lens_pad = np.zeros(_NIBBLES * 2, np.uint8)
            lens_pad[:ALPHABET] = lk.astype(np.uint8)
            nibbles += (lens_pad[0::2] | (lens_pad[1::2] << 4)).tobytes()
        offs = offs_all[:used_chunks].astype(np.int64)
        anchored = ok and (use_mt or _anchor_bytes(R) * 20 < nw * 4)
        mode = (1 if anchored else 0) | (2 if use_mt else 0)
        payload = _BLOCK_HEAD.pack(ns[b], m, idx0, tb, mode)
        if use_mt:
            payload += bytes([len(lens)])
        payload += nibbles
        payload += struct.pack("<I", used_chunks)
        payload += struct.pack("<I", int(offs[0]))
        payload += _pack_fields_np(np.diff(offs), DELTA_BITS)
        if use_mt:
            payload += _pack_fields_np(
                remap[sels[:used_chunks]].astype(np.uint32), SEL_BITS
            )
        if mode & 1:
            a = anchors.astype(np.uint32)
            payload += struct.pack("<I", a.shape[0]) + _pack_anchors(a)
        payload += ent[:nw].astype("<u4").tobytes()
        return payload

    with timing.stage("bz.entropy+pull"):
        # Per-block ASYNC host copies: block b's meta transfer rides
        # under blocks b+1..B's device compute instead of waiting for
        # the whole batch.
        for b in range(B):
            per[b][0].copy_to_host_async()
        metas_np = [np.asarray(per[b][0]) for b in range(B)]
        # Word bucket: all metas are on host by this point (the
        # comprehension above materializes them in dispatch order), so
        # size every block's pull from the batch MAXIMUM — no block can
        # overflow, so no synchronous re-pull tail (sizing from block 0
        # alone would serialize batches whose later blocks compress
        # worse than block 0).
        take0 = _bucket_words(
            max(-(-int(m[4]) // 32) for m in metas_np), out_words)
        ents = []
        for b in range(B):
            e = _take_words(per[b][1], take0)
            e.copy_to_host_async()
            ents.append(e)
        payloads = []
        for b in range(B):
            nw = -(-int(metas_np[b][4]) // 32)
            if nw > take0:
                take_b = _bucket_words(nw, out_words)
                ent_np = np.asarray(_take_words(per[b][1], take_b))
            else:
                ent_np = np.asarray(ents[b])
            payloads.append(encode_one(b, metas_np[b], ent_np))
    return payloads


def compress(data: bytes | np.ndarray, block_size: int = 900_000) -> bytes:
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    n = arr.shape[0]
    cap = _cap_for(block_size)
    starts = list(range(0, max(n, 1), block_size))
    payloads = []
    for i in range(0, len(starts), MAX_BATCH):
        group = starts[i: i + MAX_BATCH]
        blocks = np.zeros((len(group), cap), np.uint8)
        ns = []
        for j, s in enumerate(group):
            chunk = arr[s: s + block_size]
            blocks[j, : chunk.shape[0]] = chunk
            ns.append(chunk.shape[0])
        payloads.extend(_encode_payloads(blocks, ns))
    c = Container(
        codec_id=CODEC_BZ, flags=0, orig_len=n, block_size=block_size,
        comp_sizes=[len(p) for p in payloads], payloads=payloads,
        data_adler=adler32_np(arr),
    )
    return c.to_bytes()


def _decompress_batch_packed(group: list[bytes], cap: int) -> list:
    """All-anchored fast path: ONE u32 H2D put carrying every block's
    scalars + lengths + selectors + offsets + anchors + words,
    device-built LUTs, ONE stacked D2H pull of the outputs.  Returns
    decoded blocks or None when some block lacks anchors (caller falls
    back).  Single-table blocks ride the same program as multi-table
    ones: their extra length tables are zero and their selectors all 0.
    """
    out_words = -(-cap * MAX_LEN // 32)
    ccap = max(1, -(-cap // CHUNK_SYMS))
    n_anch = -(-cap // ANCHOR_STRIDE)
    sc = -(-ccap // 4)
    B = len(group)
    parsed = [_parse_block(p) for p in group]
    if any(p[7] is None or p[7].shape[0] != n_anch for p in parsed):
        return None
    K = max(p[4].shape[0] for p in parsed)
    nw_max = max(-(-p[3] // 32) for p in parsed)
    w_pad = _bucket_words(max(nw_max, 1), out_words)
    width = 4 + K * 65 + sc + ccap + n_anch + w_pad
    arr = np.zeros((B, width), np.uint32)
    ns = []
    for j, (n, m, idx0, tb, lengths, sel, bit_offsets, anchors, words) in \
            enumerate(parsed):
        ns.append(n)
        arr[j, 0], arr[j, 1], arr[j, 2], arr[j, 3] = tb, m, idx0, 1
        o = 4
        for k in range(lengths.shape[0]):
            lens_pad = np.zeros(260, np.uint8)
            lens_pad[:ALPHABET] = lengths[k].astype(np.uint8)
            arr[j, o + k * 65: o + (k + 1) * 65] = lens_pad.view("<u4")
        o += K * 65
        if sel is not None:
            sel_pad = np.zeros(sc * 4, np.uint8)
            sel_pad[: sel.shape[0]] = sel
            arr[j, o: o + sc] = sel_pad.view("<u4")
        o += sc
        arr[j, o: o + ccap] = tb
        arr[j, o: o + bit_offsets.shape[0]] = bit_offsets.astype(np.uint32)
        o += ccap
        arr[j, o: o + n_anch] = anchors.astype(np.uint32)
        o += n_anch
        arr[j, o: o + words.shape[0]] = words
    # One program per block, as in the forward direction.  Upload per
    # block too: block 0's inverse starts after ONE row's put instead
    # of the whole batch's,
    # and later rows upload under earlier blocks' compute; likewise
    # each block's output copy is requested async the moment its
    # program is dispatched, so D2H rides under the next block's
    # compute and only the LAST block's pull is on the critical path.
    outs = []
    with timing.stage("bz.inverse+pull"):
        for j in range(B):
            o = _inverse_packed(jnp.asarray(arr[j]), cap, w_pad, K)
            o.copy_to_host_async()
            outs.append(o)
        pulled = [np.asarray(o) for o in outs]
    return [pulled[j][: ns[j]] for j in range(B)]


def decompress(buf: bytes) -> bytes:
    c = Container.from_bytes(buf)
    assert c.codec_id == CODEC_BZ
    cap = _cap_for(c.block_size)
    wcap = -(-cap * MAX_LEN // 32)
    ccap = max(1, -(-cap // CHUNK_SYMS))
    parts = []
    for i in range(0, len(c.payloads), MAX_BATCH):
        group = c.payloads[i: i + MAX_BATCH]
        fast = _decompress_batch_packed(group, cap)
        if fast is not None:
            parts.extend(fast)
            continue
        # mixed group: batch the anchored blocks (which include every
        # multi-table block), doubling-decode the anchor-less ones
        # (always single-table by encode invariant)
        for payload in group:
            n, m, idx0, tb, lengths, sel, bit_offsets, anchors, words = \
                _parse_block(payload)
            if anchors is not None:
                parts.extend(_decompress_batch_packed([payload], cap))
                continue
            assert sel is None, "multi-table blocks always carry anchors"
            words_p = np.zeros(wcap, np.uint32)
            words_p[: words.shape[0]] = words
            offs_p = np.full(ccap, tb, np.int32)
            offs_p[: bit_offsets.shape[0]] = bit_offsets
            table = HuffmanTable.from_lengths(lengths[0], MAX_LEN)
            args = (
                jnp.asarray(words_p), jnp.int32(tb), jnp.int32(m),
                jnp.int32(idx0), jnp.asarray(table.lut_sym),
                jnp.asarray(table.lut_len), jnp.asarray(offs_p),
            )
            block = _inverse(*args, cap)
            parts.append(np.asarray(block)[:n])
    out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
    if not c.verify_data(np.frombuffer(out, np.uint8)):
        raise ValueError("data checksum mismatch after decompress")
    return out
