"""Move-to-front transform as a parallel scan.

cudpp parallelizes MTF with a 3-phase list-composition scan over
64-byte substrings (`mtf_reduction_kernel` etc.,
`compress_kernel.cuh:1340-1727`).  The formulation here is simpler and
fully vectorized by exploiting two associative structures:

Forward: the MTF table state before chunk c is fully determined by the
  *last-occurrence position* of every symbol in the prefix — and
  last-occurrence composes with elementwise `max`.  One
  `lax.associative_scan(max)` over per-chunk recency vectors plus one
  256-wide sort per chunk reconstructs every chunk's starting table;
  chunks then encode in lockstep (a C-step `lax.scan` vectorized over
  all chunks).

Inverse: processing a *rank* moves position r to the front — a purely
  positional permutation of the table.  Permutations compose by gather,
  so chunk permutations combine with `lax.associative_scan`, and the
  exclusive prefix permutation applied to the identity table IS each
  chunk's starting table.

Both directions are causal, so padded tails never disturb the valid
prefix — callers slice instead of masking.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_CHUNK = 128  # 2x cudpp MTF_PER_THREAD (`cudpp_globals.h:54`): halves the
# inverse permutation-composition scan volume (the decode hotspot)


def _move_to_front(table: jax.Array, rank: jax.Array, value: jax.Array):
    """table [B,256]; move position `rank` (holding `value`) to front.

    Tables ride in uint8 (all entries are symbols/positions < 256):
    the scan loops stream [B,256] state every step, so element width
    is directly HBM traffic on the decode hot path.
    """
    pos = jnp.arange(table.shape[1], dtype=jnp.uint8)[None, :]
    shifted = jnp.concatenate([value[:, None], table[:, :-1]], axis=1)
    return jnp.where(pos <= rank[:, None], shifted, table)


@partial(jax.jit, static_argnames=("chunk",))
def mtf_encode(data: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """MTF-encode uint8[N] -> uint8[N] of ranks (N must be chunk-padded
    by the caller; tail junk stays in the tail)."""
    n = data.shape[0]
    assert n % chunk == 0, "pad input to a multiple of `chunk`"
    nchunks = n // chunk
    d = data.astype(jnp.uint8).reshape(nchunks, chunk)

    # Per-chunk recency: position of last occurrence of each symbol
    # (one scatter-max, an atomic max on the GPU).
    gpos = jnp.arange(n, dtype=jnp.int32).reshape(nchunks, chunk)
    recency = jnp.full((nchunks, 256), -1, jnp.int32)
    recency = recency.at[
        jnp.arange(nchunks, dtype=jnp.int32)[:, None],
        d.astype(jnp.int32),
    ].max(gpos)

    # Exclusive max-scan -> recency of each symbol before the chunk starts.
    incl = jax.lax.associative_scan(jnp.maximum, recency, axis=0)
    before = jnp.concatenate(
        [jnp.full((1, 256), -1, jnp.int32), incl[:-1]], axis=0
    )

    # Starting table per chunk: seen symbols by recency (newest first),
    # then unseen symbols in natural order (initial table = identity).
    syms = jnp.arange(256, dtype=jnp.int32)[None, :]
    key = jnp.where(before >= 0, before, -2 - syms)
    order = jnp.argsort(-key, axis=1, stable=True).astype(jnp.uint8)
    table0 = order  # order holds symbol values (identity gathered)

    # Lockstep serial encode inside chunks, vectorized across chunks.
    def step(table, col):
        eq = table == col[:, None]
        rank = jnp.argmax(eq, axis=1).astype(jnp.uint8)
        return _move_to_front(table, rank, col), rank

    _, ranks = jax.lax.scan(step, table0, d.T)
    return ranks.T.reshape(n)


@partial(jax.jit, static_argnames=("chunk",))
def mtf_decode(ranks: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """Inverse MTF: uint8[N] ranks -> uint8[N] symbols."""
    n = ranks.shape[0]
    assert n % chunk == 0, "pad input to a multiple of `chunk`"
    nchunks = n // chunk
    r = ranks.astype(jnp.uint8).reshape(nchunks, chunk)

    # Build each chunk's positional permutation serially (C steps),
    # vectorized across chunks: perm' = perm o p_step, where p_step
    # moves position `rank` to the front.
    ident = jnp.broadcast_to(
        jnp.arange(256, dtype=jnp.uint8)[None, :], (nchunks, 256)
    )

    # perm[col] is fetched as a masked row-max reduction (vectorised
    # across chunks) rather than a row-wise take_along_axis.
    pos = jnp.arange(256, dtype=jnp.uint8)[None, :]

    def build(perm, col):
        val = jnp.max(jnp.where(pos == col[:, None], perm, 0), axis=1)
        return _move_to_front(perm, col, val), None

    chunk_perm, _ = jax.lax.scan(build, ident, r.T)

    # Exclusive composition scan: (a o b)[i] = a[b[i]], a row-wise
    # gather.
    def compose(a, b):
        return jnp.take_along_axis(a, b.astype(jnp.int32), axis=-1)

    incl = jax.lax.associative_scan(compose, chunk_perm, axis=0)
    table0 = jnp.concatenate([ident[:1], incl[:-1]], axis=0)
    # The starting table of chunk c is the prefix permutation applied to
    # the identity — i.e. the permutation itself.

    def step(table, col):
        sym = jnp.max(jnp.where(pos == col[:, None], table, 0), axis=1)
        return _move_to_front(table, col, sym), sym

    _, syms = jax.lax.scan(step, table0, r.T)
    return syms.T.reshape(n)


def mtf_encode_np(data):
    """Numpy gold (cudpp `computeMtfGold` semantics, `test_compress.cpp:93`)."""
    import numpy as np

    table = list(range(256))
    out = np.empty(len(data), np.uint8)
    for i, b in enumerate(np.asarray(data)):
        r = table.index(int(b))
        out[i] = r
        table.insert(0, table.pop(r))
    return out
