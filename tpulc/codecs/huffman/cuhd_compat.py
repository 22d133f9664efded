"""CUHD drop-in interop: llhuff bitstream semantics.

The reference demo (`cuhd-icpp/src/demo.cc:33-183`) compresses with the
length-limited llhuff encoder and writes the RAW unit stream — no
header, no table serialization; the decoder table lives in memory
(`demo.cc:110-117`).  Interop therefore means bitstream compatibility:

  - length-limited code lengths, max 11 bits (`MAX_CODEWORD_LENGTH`
    `include/cuhd_constants.h:5`), package-merge
    (`llhuffman_encoder.cc:18-158`);
  - canonical codeword assignment in increasing-length order with the
    reference's `code = (code + 1) << (next_len - len)` recurrence
    (`llhuffman_encoder.cc:183-196`);
  - MSB-first packing into 32-bit units, zero-padded tail
    (`encode_memory`, `llhuffman_encoder.cc:200-239`) — the same unit
    convention as `tpulc.primitives.bits`.

The reference's within-length symbol order comes from unordered_map
iteration (implementation-defined); this module uses ascending symbol
value — any decoder gets the table from the encoder, so interop holds
for every table produced HERE, and streams from the reference decode
given its table's (symbol, length) pairs.

Decode uses the gap-array self-synchronizing decoder
(`codecs/huffman/decode.huffman_decode`) — no partition metadata
needed, exactly the CUHD scenario, with the demo's 4-unit subsequences
(`demo.cc:25`).
"""

from __future__ import annotations

import numpy as np

MAX_CODEWORD_LENGTH = 11  # cuhd_constants.h:5
SUBSEQ_UNITS = 4          # demo.cc:25 (SUBSEQ_SIZE)


def llhuff_symbol_lengths(data: np.ndarray) -> dict[int, int]:
    """Optimal length-limited code lengths (<= 11 bits) per symbol.

    Mirrors `get_symbol_lengths` (package-merge over per-symbol coins);
    ties resolved by ascending symbol value rather than hash order.
    """
    from tpulc.codecs.huffman.tables import package_merge_lengths

    data = np.asarray(data, np.uint8)
    freqs = np.bincount(data, minlength=256).astype(np.int64)
    present = np.flatnonzero(freqs)
    if present.shape[0] == 0:
        return {}
    if present.shape[0] == 1:
        return {int(present[0]): 1}
    lens = package_merge_lengths(freqs, MAX_CODEWORD_LENGTH)
    return {int(s): int(lens[s]) for s in present}


def llhuff_encoder_table(lengths: dict[int, int]) -> dict[int, tuple[int, int]]:
    """(symbol -> (codeword, length)) with the reference's canonical
    recurrence (`llhuffman_encoder.cc:183-196`)."""
    items = sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))
    table: dict[int, tuple[int, int]] = {}
    code = 0
    cur_len = items[0][1]
    for i, (sym, ln) in enumerate(items):
        table[sym] = (code, cur_len)
        next_len = items[i + 1][1] if i + 1 < len(items) else cur_len
        code = (code + 1) << (next_len - cur_len)
        cur_len = next_len
    return table


def llhuff_encode(data: np.ndarray,
                  table: dict[int, tuple[int, int]] | None = None
                  ) -> tuple[bytes, dict[int, int]]:
    """Encode to the raw cuhd unit stream (bit-identical to
    `encode_memory` given the same table).

    Returns (unit stream bytes — little-endian u32 units as the demo
    writes raw memory, lengths dict for the decoder).
    """
    data = np.asarray(data, np.uint8)
    if table is None:
        lengths = llhuff_symbol_lengths(data)
        table = llhuff_encoder_table(lengths)
    else:
        lengths = {s: ln for s, (_, ln) in table.items()}
    codes = np.zeros(256, np.uint32)
    lens = np.zeros(256, np.int64)
    for s, (c, ln) in table.items():
        codes[s] = c
        lens[s] = ln
    sym_lens = lens[data]
    total_bits = int(sym_lens.sum())
    # ceil to bytes then to units (get_encoder_table:167-180)
    nbytes = (total_bits + 7) // 8
    n_units = -(-nbytes // 4)

    # vectorized MSB-first packing (same layout as primitives.bits)
    from tpulc.primitives.bits import pack_bits
    import jax.numpy as jnp

    words, tb = pack_bits(
        jnp.asarray(codes[data]), jnp.asarray(sym_lens.astype(np.int32)),
        max(1, n_units),
    )
    assert int(tb) == total_bits
    units = np.asarray(words[:n_units]).astype("<u4")
    return units.tobytes(), lengths


def cuhd_decode(stream: bytes, lengths: dict[int, int], n_out: int
                ) -> np.ndarray:
    """Decode a raw cuhd unit stream given the (symbol -> length) table.

    Self-synchronizing parallel decode — tpulc's realization of the
    4-phase gap-array algorithm (`cuhd_gpu_decoder.cu:422-520`), with
    the demo's 128-bit subsequences.
    """
    import jax.numpy as jnp

    from tpulc.codecs.huffman.decode import huffman_decode

    table = llhuff_encoder_table(lengths)
    lens_arr = np.zeros(256, np.int32)
    for s, ln in lengths.items():
        lens_arr[s] = ln
    # build the flat 2^11 LUT from the reference's canonical codes
    lut_sym = np.zeros(1 << MAX_CODEWORD_LENGTH, np.int32)
    lut_len = np.zeros(1 << MAX_CODEWORD_LENGTH, np.int32)
    for s, (c, ln) in table.items():
        shift = MAX_CODEWORD_LENGTH - ln
        lo = c << shift
        lut_sym[lo: lo + (1 << shift)] = s
        lut_len[lo: lo + (1 << shift)] = ln
    words = np.frombuffer(stream, "<u4").astype(np.uint32)
    total_bits = np.int32(words.shape[0] * 32)
    out, _ = huffman_decode(
        jnp.asarray(words), jnp.int32(total_bits), n_out,
        jnp.asarray(lut_sym), jnp.asarray(lut_len), MAX_CODEWORD_LENGTH,
        sub_bits=SUBSEQ_UNITS * 32,
    )
    return np.asarray(out[:n_out])


def compress_file(src: str, dst: str) -> dict[int, int]:
    """Demo-equivalent: read file, write raw compressed units.

    Returns the lengths table (the demo keeps it in memory; callers
    that need persistence can store it with `save_table`)."""
    data = np.fromfile(src, np.uint8)
    stream, lengths = llhuff_encode(data)
    with open(dst, "wb") as f:
        f.write(stream)
    return lengths


def save_table(lengths: dict[int, int], path: str) -> None:
    """256-byte sidecar: per-symbol code length (0 = absent)."""
    arr = np.zeros(256, np.uint8)
    for s, ln in lengths.items():
        arr[s] = ln
    arr.tofile(path)


def load_table(path: str) -> dict[int, int]:
    arr = np.fromfile(path, np.uint8)
    return {int(s): int(arr[s]) for s in np.flatnonzero(arr)}


def decompress_file(src: str, table_path: str, n_out: int, dst: str) -> None:
    lengths = load_table(table_path)
    with open(src, "rb") as f:
        stream = f.read()
    out = cuhd_decode(stream, lengths, n_out)
    out.astype(np.uint8).tofile(dst)
