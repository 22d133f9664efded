"""Data-parallel primitives shared by all codecs.

JAX replacements for the reference's L1 layer (cub/moderngpu/
thrust/b40c sort-scan-histogram machinery — SURVEY.md §1, §2.4): here
they are `jax.lax` sorts and scans plus scatter/gather bit packing.
"""

from tpulc.primitives.bits import (  # noqa: F401
    exclusive_cumsum,
    pack_bits,
    peek_bits,
    bitreverse_u32,
)
from tpulc.primitives.histogram import byte_histogram  # noqa: F401
from tpulc.primitives.checksum import adler32, adler32_np, crc32_bzip2_np  # noqa: F401
