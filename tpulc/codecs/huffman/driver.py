"""Huffman codec driver: block compress/decompress against the container.

Per-block payload layout (little-endian):

    n           u32   symbols in this block
    total_bits  u32   valid bits in the codeword stream
    mode        u8    bit0: aligned chunk-offset table present
    lengths     128B  256 code lengths, nibble-packed (max_len <= 15)
    [nchunks    u32   when mode&1
     offsets    u32 * nchunks  absolute bit offset of each chunk]
    words       4B * ceil(total_bits/32)  MSB-first codeword stream

The aligned table stores the bit offset of every CHUNK_SYMS-symbol
group (finer than cudpp's 4096-char Huffman blocks, `cudpp_globals.h:65`,
since the decode walk's trip count is the chunk symbol count), letting
the decoder skip the self-synchronization phases.  Without it, the
scan-composition decoder recovers the partition on its own (CUHD mode).
"""

from __future__ import annotations

import struct
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpulc.codecs.huffman.tables import DEFAULT_MAX_LEN, HuffmanTable
from tpulc.codecs.huffman.decode import (
    huffman_decode,
    huffman_decode_uniform,
)
from tpulc.pipeline.container import Container
from tpulc.pipeline.registry import CODEC_HUFFMAN
from tpulc.primitives.bits import pack_bits
from tpulc.primitives.checksum import adler32_np
from tpulc.utils.backend import on_gpu

CHUNK_SYMS = 256      # v1 wire mode (32-bit absolute offsets)
CHUNK_SYMS_V2 = 128   # v2 wire mode (16-bit offset deltas) — same
                      # table overhead per symbol (0.125 bits), half
                      # the serial walk of v1
_BLOCK_HEAD = struct.Struct("<IIB")

FLAG_ALIGNED = 1
FLAG_ALIGNED2 = 2     # per-chunk u16 bit-length deltas + chunk_log u8


@partial(jax.jit, static_argnames=("out_words", "nchunks", "chunk_syms"))
def _encode_block(block, n, codes, lengths, out_words: int, nchunks: int,
                  chunk_syms: int = CHUNK_SYMS):
    """Jitted per-block encode. Padding symbols get zero length."""
    idx = block.astype(jnp.int32)
    valid = jnp.arange(block.shape[0], dtype=jnp.int32) < n
    sym_lens = jnp.where(valid, lengths[idx], 0)
    sym_codes = jnp.where(valid, codes[idx], 0).astype(jnp.uint32)
    words, total_bits = pack_bits(sym_codes, sym_lens, out_words)
    off = jnp.cumsum(sym_lens) - sym_lens
    chunk_offsets = off[:: chunk_syms][:nchunks].astype(jnp.int32)
    # Chunks that start at/after n carry total_bits (empty range).
    chunk_valid = (jnp.arange(nchunks, dtype=jnp.int32) * chunk_syms) < n
    chunk_offsets = jnp.where(chunk_valid, chunk_offsets, total_bits)
    return words, total_bits, chunk_offsets


@partial(jax.jit, static_argnames=("max_len", "n_out", "sub_bits"))
def _decode_block_selfsync(words, total_bits, lut_sym, lut_len,
                           max_len: int, n_out: int, sub_bits: int = 512):
    return huffman_decode(words, total_bits, n_out, lut_sym, lut_len,
                          max_len, sub_bits=sub_bits)


@partial(jax.jit, static_argnames=("max_len", "n_out", "chunk_syms"))
def _decode_block_aligned(words, total_bits, lut_sym, lut_len,
                          max_len: int, n_out: int, bit_offsets,
                          chunk_syms: int = CHUNK_SYMS):
    return huffman_decode_uniform(
        words, total_bits, n_out, lut_sym, lut_len, max_len,
        bit_offsets, chunk_syms,
    )


def compress_block(block: np.ndarray, max_len: int = DEFAULT_MAX_LEN,
                   block_cap: int | None = None, aligned: bool = True,
                   chunk_syms: int = CHUNK_SYMS_V2) -> bytes:
    """Compress one block (uint8) to a payload. `block_cap` fixes the
    padded size so every block reuses one compiled program.

    `chunk_syms` selects the aligned wire mode: 256 writes the v1
    layout (u32 absolute chunk offsets); any other power of two writes
    the v2 layout (u16 per-chunk bit-length deltas — same bits per
    symbol at 128, and the decoder rebuilds absolutes with one
    cumsum)."""
    n = block.shape[0]
    cap = block_cap or n
    assert n <= cap
    v2 = chunk_syms != CHUNK_SYMS
    assert chunk_syms & (chunk_syms - 1) == 0
    assert chunk_syms * max_len < (1 << 16) or not v2
    # The decoders walk symbol pairs; reject at compress time instead
    # of failing with a trace-time assertion at decompress time.
    if aligned and chunk_syms % 2 != 0:
        raise ValueError(
            f"chunk_syms={chunk_syms} must be even (pairwise decode)")
    freqs = np.bincount(block, minlength=256)
    table = HuffmanTable.from_freqs(freqs, max_len)
    padded = np.zeros(cap, np.uint8)
    padded[:n] = block
    out_words = -(-cap * max_len // 32)
    nchunks = max(1, -(-cap // chunk_syms))
    words, total_bits, chunk_offsets = _encode_block(
        jnp.asarray(padded), jnp.int32(n),
        jnp.asarray(table.codes), jnp.asarray(table.lengths),
        out_words, nchunks, chunk_syms,
    )
    total_bits = int(total_bits)
    nw = -(-total_bits // 32)
    words_np = np.asarray(words[:nw]).astype("<u4")
    lens = np.asarray(table.lengths, np.uint8)
    nibbles = (lens[0::2] | (lens[1::2] << 4)).tobytes()
    mode = (FLAG_ALIGNED2 if v2 else FLAG_ALIGNED) if aligned else 0
    payload = _BLOCK_HEAD.pack(n, total_bits, mode) + nibbles
    if aligned:
        used_chunks = max(1, -(-n // chunk_syms))
        offs = np.asarray(chunk_offsets[:used_chunks]).astype(np.int64)
        if v2:
            ends = np.append(offs[1:], total_bits)
            deltas = (ends - offs).astype("<u2")
            payload += struct.pack(
                "<BI", chunk_syms.bit_length() - 1, used_chunks
            ) + deltas.tobytes()
        else:
            payload += struct.pack("<I", used_chunks) \
                + offs.astype("<u4").tobytes()
    payload += words_np.tobytes()
    return payload


def decompress_block(payload: bytes, max_len: int = DEFAULT_MAX_LEN,
                     block_cap: int | None = None) -> np.ndarray:
    n, total_bits, mode = _BLOCK_HEAD.unpack(payload[: _BLOCK_HEAD.size])
    off = _BLOCK_HEAD.size
    nib = np.frombuffer(payload[off: off + 128], np.uint8)
    off += 128
    lengths = np.zeros(256, np.int32)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    bit_offsets = None
    chunk_syms = CHUNK_SYMS
    if mode & FLAG_ALIGNED2:
        chunk_log, nchunks = struct.unpack("<BI", payload[off: off + 5])
        off += 5
        chunk_syms = 1 << chunk_log
        deltas = np.frombuffer(payload[off: off + 2 * nchunks], "<u2")
        off += 2 * nchunks
        bit_offsets = np.cumsum(deltas.astype(np.int64)) - deltas
        bit_offsets = bit_offsets.astype(np.int32)
    elif mode & FLAG_ALIGNED:
        (nchunks,) = struct.unpack("<I", payload[off: off + 4])
        off += 4
        bit_offsets = np.frombuffer(
            payload[off: off + 4 * nchunks], "<u4"
        ).astype(np.int32)
        off += 4 * nchunks
    nw = -(-total_bits // 32)
    words = np.frombuffer(payload[off: off + 4 * nw], "<u4")
    cap = block_cap or n
    wcap = -(-cap * max_len // 32)
    words_p = np.zeros(wcap, np.uint32)
    words_p[:nw] = words
    table = HuffmanTable.from_lengths(lengths, max_len)
    if bit_offsets is not None:
        ccap = max(1, -(-cap // chunk_syms))
        offs_p = np.full(ccap, total_bits, np.int32)
        offs_p[: bit_offsets.shape[0]] = bit_offsets
        out = _decode_block_aligned(
            jnp.asarray(words_p), jnp.int32(total_bits),
            jnp.asarray(table.lut_sym), jnp.asarray(table.lut_len),
            max_len, cap, jnp.asarray(offs_p), chunk_syms,
        )
        return np.asarray(out[:n])
    from tpulc.codecs.huffman.autotune import optimal_sub_bits

    sub_bits = optimal_sub_bits(total_bits, n, max_len)
    out, n_valid = _decode_block_selfsync(
        jnp.asarray(words_p), jnp.int32(total_bits),
        jnp.asarray(table.lut_sym), jnp.asarray(table.lut_len),
        max_len, cap, sub_bits,
    )
    assert int(n_valid) >= n, "self-sync decode lost symbols"
    return np.asarray(out[:n])


@partial(jax.jit, static_argnames=("chunk_syms", "max_len"))
def _decode_batch_ranks(words, total_bits, lengths, offs,
                        chunk_syms: int, max_len: int):
    from tpulc.codecs.huffman.decode import huffman_decode_ranks_batch

    return huffman_decode_ranks_batch(
        words, total_bits, lengths, offs, chunk_syms, max_len
    )


def _parse_aligned_group(group: list[bytes], cap: int, max_len: int):
    """Parse an all-aligned payload group into the fixed-shape batch
    arrays the batched decoders consume.  Returns None when some block
    lacks the aligned offset table; else
    (words [Bp,w_pad] u32, tbits [Bp] i32, lens [Bp,256] i32,
    offs [Bp,ccap] i32, ns list[int], chunk_syms)."""
    parsed = []
    chunk_syms = None
    for payload in group:
        n, total_bits, mode = _BLOCK_HEAD.unpack(payload[: _BLOCK_HEAD.size])
        if not (mode & (FLAG_ALIGNED | FLAG_ALIGNED2)):
            return None
        off = _BLOCK_HEAD.size
        nib = np.frombuffer(payload[off: off + 128], np.uint8)
        off += 128
        if mode & FLAG_ALIGNED2:
            chunk_log, nchunks = struct.unpack(
                "<BI", payload[off: off + 5])
            off += 5
            cs = 1 << chunk_log
            deltas = np.frombuffer(payload[off: off + 2 * nchunks], "<u2")
            off += 2 * nchunks
            bit_offsets = (np.cumsum(deltas.astype(np.int64))
                           - deltas).astype(np.uint32)
        else:
            cs = CHUNK_SYMS
            (nchunks,) = struct.unpack("<I", payload[off: off + 4])
            off += 4
            bit_offsets = np.frombuffer(
                payload[off: off + 4 * nchunks], "<u4"
            )
            off += 4 * nchunks
        if chunk_syms is None:
            chunk_syms = cs
        elif chunk_syms != cs:
            return None            # mixed chunking: per-block fallback
        nw = -(-total_bits // 32)
        words = np.frombuffer(payload[off: off + 4 * nw], "<u4")
        parsed.append((n, total_bits, nib, bit_offsets, words))
    ccap = max(1, -(-cap // chunk_syms))
    # Batch shape bucketed: powers of two up to 32, then multiples of
    # 32 (a fixed batch would make a 4-block input decode a full
    # batch's worth of work, and a pure pow-2 bucket pads 96 blocks to
    # 128).  Buckets cost at most 9 compiled programs per w_pad.
    B = len(parsed)
    if B <= 32:
        Bp = 1 << max(0, (B - 1).bit_length())
    else:
        Bp = min(max_batch(), -(-B // 32) * 32)
    out_words = -(-cap * max_len // 32)
    nw_max = max(max((-(-p[1] // 32) for p in parsed)), 1)
    w_pad = min(max(4096, 1 << (nw_max - 1).bit_length()), out_words)
    words_a = np.zeros((Bp, w_pad), np.uint32)
    tbits_a = np.zeros(Bp, np.int32)
    lens_a = np.zeros((Bp, 256), np.int32)
    offs_a = np.zeros((Bp, ccap), np.int32)
    for j, (n, tb, nib, bit_offsets, words) in enumerate(parsed):
        words_a[j, : words.shape[0]] = words
        tbits_a[j] = tb
        lens_a[j, 0::2] = nib & 0xF
        lens_a[j, 1::2] = nib >> 4
        offs_a[j, :] = tb
        offs_a[j, : bit_offsets.shape[0]] = bit_offsets
    return (words_a, tbits_a, lens_a, offs_a, [p[0] for p in parsed],
            chunk_syms)


def _decompress_batch_aligned(group: list[bytes], cap: int,
                              max_len: int) -> list | None:
    """All-aligned fast path: the whole batch decodes in ONE program
    (`decode_batch_device`).  Returns None when some block lacks the
    aligned offset table (caller falls back)."""
    prep = _parse_aligned_group(group, cap, max_len)
    if prep is None:
        return None
    words_a, tbits_a, lens_a, offs_a, ns, chunk = prep
    syms = decode_batch_device(
        jnp.asarray(words_a), jnp.asarray(tbits_a), jnp.asarray(lens_a),
        jnp.asarray(offs_a), chunk, max_len,
    )
    pulled = np.asarray(syms)
    return [pulled[j, : ns[j]] for j in range(len(ns))]


@partial(jax.jit, static_argnames=("chunk_syms", "max_len", "interpret"))
def _decode_batch_walk(words, total_bits, lengths, offs, chunk_syms: int,
                       max_len: int, interpret: bool = False):
    """Aligned batch decode through the one-thread-per-chunk kernel
    (`pallas_decode.walk_chunks`): block b's chunks read table b and
    the words from b * w_pad on."""
    from tpulc.codecs.huffman.device_tables import canonical_lut_packed
    from tpulc.codecs.huffman.pallas_decode import walk_chunks

    B, w_pad = words.shape
    ccap = offs.shape[1]
    luts = jax.vmap(lambda ln: canonical_lut_packed(ln, max_len))(lengths)
    ends = jnp.concatenate([offs[:, 1:], total_bits[:, None]], axis=1)
    blk = jnp.repeat(jnp.arange(B, dtype=jnp.int32), ccap)
    flat = jnp.concatenate([words.reshape(-1), jnp.zeros(2, jnp.uint32)])
    syms = walk_chunks(flat, blk * w_pad, offs.reshape(-1),
                       ends.reshape(-1), luts.reshape(-1),
                       blk << max_len, chunk_syms, max_len,
                       out_dtype=jnp.uint8, interpret=interpret)
    return syms.reshape(B, ccap * chunk_syms)


def decode_batch_device(words_a, tbits_a, lens_a, offs_a,
                        chunk: int, max_len: int):
    """Decode one parsed aligned batch on the device; returns the device
    array uint8 [B, ccap*chunk] without pulling it to host.  The GPU
    runs the chunk-walk kernel, the CPU the batched rank decoder."""
    dec = _decode_batch_walk if on_gpu() else _decode_batch_ranks
    return dec(words_a, tbits_a, lens_a, offs_a, chunk, max_len)


def compress(data: bytes | np.ndarray, block_size: int = 1 << 20,
             max_len: int = DEFAULT_MAX_LEN, aligned: bool = True,
             chunk_syms: int = CHUNK_SYMS_V2) -> bytes:
    """Batched device encode (see `compress_batched` below — the
    per-block host loop paid ~3 device syncs per block and was the
    slow side of the codec)."""
    return compress_batched(data, block_size, max_len, aligned,
                            chunk_syms)


def max_batch() -> int:
    """Blocks per device round (bounds the device working set).  The
    CPU keeps the bucket small: its fixed batch shape pads small test
    inputs."""
    return 128 if on_gpu() else 32


def decompress(buf: bytes, max_len: int = DEFAULT_MAX_LEN) -> bytes:
    c = Container.from_bytes(buf)
    assert c.codec_id == CODEC_HUFFMAN
    parts = []
    nb = max_batch()
    for i in range(0, len(c.payloads), nb):
        group = c.payloads[i: i + nb]
        fast = _decompress_batch_aligned(group, c.block_size, max_len)
        if fast is not None:
            parts.extend(fast)
        else:
            parts.extend(
                decompress_block(p, max_len, block_cap=c.block_size)
                for p in group
            )
    out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
    if not c.verify_data(np.frombuffer(out, np.uint8)):
        raise ValueError("data checksum mismatch after decompress")
    return out


@partial(jax.jit, static_argnames=("out_words", "nchunks", "chunk_syms",
                                   "max_len"))
def _encode_batch(blocks, ns, out_words: int, nchunks: int,
                  chunk_syms: int, max_len: int):
    """Whole-group encode in ONE device program: per-block histogram,
    DEVICE package-merge + canonical codes (bit-identical to the host
    build for block histograms — `device_tables`), bit packing, chunk
    offsets.  Replaces a per-block host loop that paid ~3 host syncs
    per block.

    Returns (words u32[B, out_words], total_bits i32[B],
    chunk_offsets i32[B, nchunks], lengths i32[B, 256])."""
    from tpulc.codecs.huffman.device_tables import (
        canonical_codes_device,
        package_merge_lengths_device,
    )

    def one(block, n):
        cap = block.shape[0]
        idx32 = block.astype(jnp.int32)
        valid = jnp.arange(cap, dtype=jnp.int32) < n
        sel = jnp.where(valid, idx32, 256)
        freqs = jnp.zeros((257,), jnp.int32).at[sel].add(
            1, mode="drop")[:256]
        lens = package_merge_lengths_device(freqs, max_len)
        codes, lens = canonical_codes_device(lens, max_len)
        # one packed (code << 5 | len) table -> ONE per-symbol gather
        packed = ((codes.astype(jnp.int32) << 5) | lens)[
            jnp.minimum(idx32, 255)]
        sym_lens = jnp.where(valid, packed & 31, 0)
        sym_codes = jnp.where(valid, packed >> 5, 0).astype(jnp.uint32)
        words, total_bits = pack_bits(sym_codes, sym_lens, out_words)
        off = jnp.cumsum(sym_lens) - sym_lens
        chunk_offsets = off[:: chunk_syms][:nchunks].astype(jnp.int32)
        chunk_valid = (jnp.arange(nchunks, dtype=jnp.int32)
                       * chunk_syms) < n
        chunk_offsets = jnp.where(chunk_valid, chunk_offsets, total_bits)
        return words, total_bits, chunk_offsets, lens

    return jax.vmap(one)(blocks, ns)


def _payload_from(nsym: int, total_bits: int, lens_np: np.ndarray,
                  offs_np, words_np: np.ndarray, aligned: bool,
                  chunk_syms: int) -> bytes:
    """Assemble one block payload from pulled device results (same wire
    bytes as `compress_block`)."""
    v2 = chunk_syms != CHUNK_SYMS
    lens8 = lens_np.astype(np.uint8)
    nibbles = (lens8[0::2] | (lens8[1::2] << 4)).tobytes()
    mode = (FLAG_ALIGNED2 if v2 else FLAG_ALIGNED) if aligned else 0
    payload = _BLOCK_HEAD.pack(nsym, total_bits, mode) + nibbles
    if aligned:
        used_chunks = max(1, -(-nsym // chunk_syms))
        offs = offs_np[:used_chunks].astype(np.int64)
        if v2:
            ends = np.append(offs[1:], total_bits)
            deltas = (ends - offs).astype("<u2")
            payload += struct.pack(
                "<BI", chunk_syms.bit_length() - 1, used_chunks
            ) + deltas.tobytes()
        else:
            payload += struct.pack("<I", used_chunks) \
                + offs.astype("<u4").tobytes()
    nw = -(-total_bits // 32)
    payload += words_np[:nw].astype("<u4").tobytes()
    return payload


def compress_batched(data: bytes | np.ndarray, block_size: int = 1 << 20,
                     max_len: int = DEFAULT_MAX_LEN, aligned: bool = True,
                     chunk_syms: int = CHUNK_SYMS_V2) -> bytes:
    """`compress` with `max_batch()` blocks per device program and ONE
    bucketed words pull per group (the bz driver's pull pattern)."""
    arr = np.frombuffer(data, np.uint8) \
        if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    if aligned and chunk_syms % 2 != 0:
        raise ValueError(
            f"chunk_syms={chunk_syms} must be even (pairwise decode)")
    n = arr.shape[0]
    cap = block_size
    out_words = -(-cap * max_len // 32)
    nchunks = max(1, -(-cap // chunk_syms))
    starts = list(range(0, max(n, 1), block_size))
    payloads = []
    nb = max_batch()
    for i in range(0, len(starts), nb):
        group = starts[i: i + nb]
        B = len(group)
        blocks = np.zeros((B, cap), np.uint8)
        ns = []
        for j, s in enumerate(group):
            chunk = arr[s: s + block_size]
            blocks[j, : chunk.shape[0]] = chunk
            ns.append(chunk.shape[0])
        words, tbits, offs, lens = _encode_batch(
            jnp.asarray(blocks), jnp.asarray(np.asarray(ns, np.int32)),
            out_words, nchunks, chunk_syms, max_len)
        tbits_np = np.asarray(tbits)
        offs_np = np.asarray(offs)
        lens_np = np.asarray(lens)
        take = min(out_words,
                   max(1, int((int(tbits_np.max()) + 31) // 32)))
        words_np = np.asarray(words[:, :take])
        for j in range(B):
            payloads.append(_payload_from(
                ns[j], int(tbits_np[j]), lens_np[j], offs_np[j],
                words_np[j], aligned, chunk_syms))
    c = Container(
        codec_id=CODEC_HUFFMAN, flags=FLAG_ALIGNED if aligned else 0,
        orig_len=n, block_size=block_size,
        comp_sizes=[len(p) for p in payloads], payloads=payloads,
        data_adler=adler32_np(arr),
    )
    return c.to_bytes()
