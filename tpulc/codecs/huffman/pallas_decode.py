"""Aligned-chunk Huffman walk as a Pallas kernel on the Triton route.

The GPU shape of CUHD's decoder (`cuhd_gpu_decoder.cu:91-139`): one
thread walks one chunk, whose start bit is known from the container's
offset table.  Each thread keeps a 64-bit bit reservoir in two uint32
registers, refills it with one 32-bit load per symbol pair, and
resolves every codeword with one lookup in a packed `(sym << 4) | len`
table of 2^L entries (small enough to stay in L1/L2).  The symbol for
step t of every chunk in a tile leaves as one coalesced row of a
step-major `[chunk_syms, nsub]` result.

One kernel serves both callers: `huffman` (one table per block, many
blocks per batch) and `bz` (one of K tables per chunk).  Each chunk
names its table by `lut_base`, the offset of its table in the flat
`lut`, and its block by `wbase`, the word offset of its block's stream
in the flat `words`.  Bit positions stay block-relative, so batches
whose total bit count exceeds 2^31 index correctly.

`interpret=True` runs the same kernel through the Pallas interpreter
(the CPU tests); the plain XLA forms are
`decode.huffman_decode_ranks_batch` and
`decode.huffman_decode_uniform_packed`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 128      # chunks per program: one thread each at 4 warps
_U32 = jnp.uint32


def _shl(x, s):
    """x << s for s in [0, 32] (a 32-bit shift by 32 is undefined)."""
    return jnp.where(s < 32, x << jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _shr(x, s):
    """x >> s (logical) for s in [0, 32]."""
    return jnp.where(s < 32, x >> jnp.clip(s, 0, 31).astype(_U32), _U32(0))


def _walk_kernel(max_len: int, chunk_syms: int, n_words: int,
                 words_ref, wbase_ref, pos_ref, end_ref, lbase_ref, lut_ref,
                 out_ref):
    L = max_len
    wbase = wbase_ref[...]
    pos = pos_ref[...]
    left = end_ref[...] - pos
    lbase = lbase_ref[...]

    def word(i):
        return words_ref[jnp.clip(wbase + i, 0, n_words - 1)]

    # Reservoir: `nav` valid bits, MSB-first, across (hi, lo).
    fidx = pos >> 5
    b = pos & 31
    w0, w1 = word(fidx), word(fidx + 1)
    hi = _shl(w0, b) | _shr(w1, 32 - b)
    lo = _shl(w1, b)
    nav = 64 - b
    fidx = fidx + 2

    def one_symbol(hi, lo, nav, left):
        p = lut_ref[lbase + (hi >> (32 - L)).astype(jnp.int32)]
        ln = p & 15
        ln = jnp.where(ln == 0, 1, ln)           # corrupt-stream guard
        active = left > 0
        sym = jnp.where(active, p >> 4, 0)
        st = jnp.where(active, ln, 0)
        hi = _shl(hi, st) | _shr(lo, 32 - st)
        lo = _shl(lo, st)
        return sym, hi, lo, nav - st, left - st

    def pair(t, carry):
        hi, lo, nav, left, fidx = carry
        need = nav <= 32
        w = word(fidx)
        hi = hi | jnp.where(need, _shr(w, nav), _U32(0))
        lo = lo | jnp.where(need, _shl(w, 32 - nav), _U32(0))
        nav = nav + jnp.where(need, 32, 0)
        fidx = fidx + jnp.where(need, 1, 0)
        s0, hi, lo, nav, left = one_symbol(hi, lo, nav, left)
        s1, hi, lo, nav, left = one_symbol(hi, lo, nav, left)
        out_ref[2 * t, :] = s0.astype(out_ref.dtype)
        out_ref[2 * t + 1, :] = s1.astype(out_ref.dtype)
        return hi, lo, nav, left, fidx

    jax.lax.fori_loop(0, chunk_syms // 2, pair, (hi, lo, nav, left, fidx))


@partial(jax.jit, static_argnames=("chunk_syms", "max_len", "out_dtype",
                                   "interpret"))
def walk_chunks(words: jax.Array, wbase: jax.Array, pos: jax.Array,
                end: jax.Array, lut: jax.Array, lut_base: jax.Array,
                chunk_syms: int, max_len: int, out_dtype=jnp.int32,
                interpret: bool = False) -> jax.Array:
    """Decode `nsub` aligned chunks of `chunk_syms` symbols each.

    words     uint32[W]   stream words of every block, back to back
    wbase     int32[nsub] word offset of each chunk's block in `words`
    pos, end  int32[nsub] first bit and end bit of each chunk, relative
                          to its block's first word
    lut       int32[T * 2^max_len]  packed (sym << 4) | len tables
    lut_base  int32[nsub] offset of each chunk's table in `lut`

    Returns out_dtype[nsub, chunk_syms]; steps past a chunk's end bit
    hold 0.  Reads may run up to two words past a chunk's last word;
    they are clamped to `words`.
    """
    L = max_len
    assert 2 * L <= 32 and chunk_syms % 2 == 0
    nsub = pos.shape[0]
    pad = -(-nsub // TILE) * TILE

    def padc(x):
        return jnp.pad(x.astype(jnp.int32), (0, pad - nsub))

    tile = pl.BlockSpec((TILE,), lambda i: (i,))
    out = pl.pallas_call(
        partial(_walk_kernel, L, chunk_syms, words.shape[0]),
        out_shape=jax.ShapeDtypeStruct((chunk_syms, pad), out_dtype),
        grid=(pad // TILE,),
        in_specs=[
            pl.BlockSpec(words.shape, lambda i: (0,)),
            tile, tile, tile, tile,
            pl.BlockSpec(lut.shape, lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((chunk_syms, TILE), lambda i: (0, i)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="huffman_walk",
    )(words.astype(_U32), padc(wbase), padc(pos), padc(end),
      padc(lut_base), lut.astype(jnp.int32))
    return out[:, :nsub].T
