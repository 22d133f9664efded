"""LZSS sliding-window codec family.

Wire formats mirrored from the reference (SURVEY.md §2.1-2.2):
  - Dipperstein lzss-0.6.2 bitstream (12-bit ring offset / 4-bit
    length, `cuda-lzss-unknown/lzss-0.6.2/lzlocal.h:70-82`) — fully
    interoperable both directions with the reference CPU codec (the
    in-repo C gold, `tpulc/gold/csrc/lzss_gold.c`, is bit-exact with
    it).
  - CULZSS flag-byte packet format (`cuda-lzss-cluster/gpu_compress.cu`).

Design (vs the reference's per-thread serial loops):
  encode — exact 3-gram candidate discovery via one `lax.sort`,
    vectorized match extension, greedy parse as pointer-doubling
    reachability, token emission via prefix-sum bit packing.
  decode — token boundaries via the same associative map-composition
    scan as the Huffman decoder (17 entry states for 9/17-bit tokens),
    then per-byte copy-source resolution by pointer doubling (the
    serial window walk of `gpu_decompress.cu:120` disappears).
"""

from tpulc.codecs.lzss.encode import lzss_encode_device  # noqa: F401
from tpulc.codecs.lzss.decode import lzss_decode_device  # noqa: F401
