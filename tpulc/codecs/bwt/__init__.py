"""Block-sorting transform family: BWT, inverse BWT, RLE stages.

Covers the reference's three block-sorters (SURVEY.md §2.4-2.6):
cudpp's DC3 suffix-array BWT (`sa_app.cu`), cuda-bzip2's iterative
segmented-doubling sort (`gpuBWTSort.cu:202-480`) and libbsc's
bounded-context sort transform (`st2.cu`).  The implementations here are
built on `jax.lax.sort` + associative scans:

- `rotsort`: full rotation-sort BWT by prefix doubling (the same
  2^k-doubling idea as `gpuBWTSort.cu`, but over whole rotations with
  wraparound, so no CPU merge stage is needed), plus a pointer-doubling
  inverse that replaces the serial LF walk.
- `stk`: bounded-context ST-k transform — fixed-width keys, one sort.
- `rle`: bzip2's RUNA/RUNB zero-run coding as scans.
"""

from tpulc.codecs.bwt.rotsort import bwt_encode, bwt_decode  # noqa: F401
from tpulc.codecs.bwt.rle import rle2_encode, rle2_decode  # noqa: F401
