"""Huffman table construction (host side, numpy).

The reference builds tables on the CPU for CUHD
(`encoder/src/llhuffman_encoder.cc:18-260`: package-merge lengths,
canonical codes, flat LUT) and in a single-thread-block GPU kernel for
cudpp (`compress_kernel.cuh:2200-2523`).  A 256-symbol table build is
microseconds of scalar work — this design keeps it on host, off the
device critical path, and ships only the packed tables to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_MAX_LEN = 12  # decode LUT = 2^12 entries; entry-state count = 12


def package_merge_lengths(freqs: np.ndarray, max_len: int = DEFAULT_MAX_LEN) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.

    Args:
      freqs: int array [num_symbols]; zero-frequency symbols get length 0.
      max_len: L, maximum codeword length.

    Returns:
      int32 lengths [num_symbols].
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    n = syms.size
    lengths = np.zeros(freqs.shape[0], dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"{n} symbols cannot fit in {max_len}-bit codes")

    w = freqs[syms]
    order = np.argsort(w, kind="stable")
    w = w[order]
    # Items are (weight, per-symbol count vector). Lists are <= 2n long
    # and there are L merge rounds — trivial for n <= 256.
    coins_w = w
    coins_c = np.eye(n, dtype=np.int32)
    prev_w = np.empty((0,), dtype=np.int64)
    prev_c = np.empty((0, n), dtype=np.int32)
    for _ in range(max_len):
        all_w = np.concatenate([coins_w, prev_w])
        all_c = np.concatenate([coins_c, prev_c])
        idx = np.argsort(all_w, kind="stable")
        all_w, all_c = all_w[idx], all_c[idx]
        npairs = all_w.size // 2
        prev_w = all_w[: 2 * npairs : 2] + all_w[1 : 2 * npairs : 2]
        prev_c = all_c[: 2 * npairs : 2] + all_c[1 : 2 * npairs : 2]
    # After L rounds, `all_w/all_c` is the merged level-1 list (fresh
    # coins + packages bubbled up from level 2).  The optimal solution
    # takes its first 2n-2 items; each occurrence of a symbol adds one
    # to that symbol's code length.
    take = 2 * n - 2
    lens = all_c[:take].sum(axis=0).astype(np.int32)
    out = np.zeros_like(lengths)
    out[syms[order]] = lens
    return out


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes from lengths: shorter first, ties by symbol index.

    Returns uint32 codes right-aligned (value in low `length` bits).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros_like(lengths, dtype=np.uint32)
    code = 0
    prev_len = 0
    for sym in sorted(np.flatnonzero(lengths), key=lambda s: (lengths[s], s)):
        code <<= lengths[sym] - prev_len
        prev_len = int(lengths[sym])
        codes[sym] = code
        code += 1
    return codes


def decode_lut(lengths: np.ndarray, codes: np.ndarray, max_len: int):
    """Flat 2^max_len decode LUT: every max_len-bit window prefix ->
    (symbol, codeword length) — the cuhd decoder-table layout
    (`llhuffman_encoder.cc:240`, `cuhd_codetable.h`).

    Returns (lut_sym uint16[2^L], lut_len uint8[2^L]).
    """
    size = 1 << max_len
    lut_sym = np.zeros(size, dtype=np.uint16)
    lut_len = np.zeros(size, dtype=np.uint8)
    for sym in np.flatnonzero(lengths):
        l = int(lengths[sym])
        lo = int(codes[sym]) << (max_len - l)
        hi = (int(codes[sym]) + 1) << (max_len - l)
        lut_sym[lo:hi] = sym
        lut_len[lo:hi] = l
    return lut_sym, lut_len


@dataclass
class HuffmanTable:
    """Packed encode+decode tables for one block (or a shared dict)."""

    lengths: np.ndarray     # int32 [S]
    codes: np.ndarray       # uint32 [S]
    lut_sym: np.ndarray     # uint16 [2^L]
    lut_len: np.ndarray     # uint8  [2^L]
    max_len: int

    @classmethod
    def from_freqs(cls, freqs: np.ndarray, max_len: int = DEFAULT_MAX_LEN):
        lengths = package_merge_lengths(freqs, max_len)
        codes = canonical_codes(lengths)
        lut_sym, lut_len = decode_lut(lengths, codes, max_len)
        return cls(lengths, codes, lut_sym, lut_len, max_len)

    @classmethod
    def from_lengths(cls, lengths: np.ndarray, max_len: int = DEFAULT_MAX_LEN):
        lengths = np.asarray(lengths, dtype=np.int32)
        codes = canonical_codes(lengths)
        lut_sym, lut_len = decode_lut(lengths, codes, max_len)
        return cls(lengths, codes, lut_sym, lut_len, max_len)
