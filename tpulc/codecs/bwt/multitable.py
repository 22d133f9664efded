"""Multi-table Huffman group refinement on device.

bzip2's `sendMTFValues` (`cuda-bzip2-ipdpsw/compress.c:242-600`) codes
the RLE2 stream with up to 6 Huffman tables, a 3-bit selector per
50-symbol group, and ~4 refinement iterations that re-assign each group
to its cheapest table and rebuild tables from their assigned groups.
That local adaptation is worth ~15-20% payload on BWT+MTF streams —
far more than global order-1 context modelling.

Device formulation: groups are the codec's decode chunks (CHUNK_SYMS
symbols), per-group histograms come from a one-hot matmul, and each
refinement iteration is two matmuls —

    cost[c, k]  = hist[c, :] . lens[k, :]        (assignment costs)
    clhist[k,:] = one_hot(sel)[k, :] . hist      (cluster rebuild)

— with float -log2(p) code-length estimates standing in for true
Huffman lengths during the loop (the final tables are built exactly,
by host package-merge, from the converged cluster histograms).  The
whole refinement runs inside one jitted program: no host round trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpulc.codecs.bwt.rle import ALPHABET


def groups_for(nsyms: int) -> int:
    """bzip2's table-count schedule (`compress.c:302-309`)."""
    if nsyms < 200:
        return 2
    if nsyms < 600:
        return 3
    if nsyms < 1200:
        return 4
    if nsyms < 2400:
        return 5
    return 6


@partial(jax.jit, static_argnames=("chunk_syms", "K", "iters"))
def refine_tables(syms, m, chunk_syms: int, K: int, iters: int = 4):
    """syms int32[cap] (valid prefix m) -> (sel int32[nchunks],
    cluster_hist int32[K, ALPHABET]).

    Empty/padding positions histogram into a discarded overflow bin, so
    trailing chunks select arbitrarily (their selectors are not stored).
    """
    cap = syms.shape[0]
    nchunks = cap // chunk_syms
    valid = jnp.arange(cap, dtype=jnp.int32) < m
    s = jnp.where(valid, syms, ALPHABET)
    oh = jax.nn.one_hot(
        s.reshape(nchunks, chunk_syms), ALPHABET + 1, dtype=jnp.float32
    )
    hist_c = oh.sum(axis=1)[:, :ALPHABET]  # [nchunks, A] f32

    # Initial tables, bzip2-style (`compress.c:316-364`): split the
    # alphabet into K runs of roughly equal total frequency; table k is
    # cheap inside its run and expensive outside.
    gfreq = hist_c.sum(axis=0)
    total = jnp.maximum(gfreq.sum(), 1.0)
    cum = jnp.cumsum(gfreq) - gfreq  # exclusive
    part = jnp.clip(
        (cum * K / total).astype(jnp.int32), 0, K - 1
    )  # [A] -> which run each symbol falls in
    ks = jnp.arange(K, dtype=jnp.int32)[:, None]
    lens = jnp.where(part[None, :] == ks, 2.0, 10.0)  # [K, A]

    sel = jnp.zeros((nchunks,), jnp.int32)
    for _ in range(iters):
        cost = hist_c @ lens.T                       # [nchunks, K]
        sel = jnp.argmin(cost, axis=1).astype(jnp.int32)
        assign = jax.nn.one_hot(sel, K, dtype=jnp.float32)  # [nchunks, K]
        clhist = assign.T @ hist_c                   # [K, A]
        p = clhist / jnp.maximum(clhist.sum(axis=1, keepdims=True), 1.0)
        lens = jnp.where(
            clhist > 0, jnp.clip(-jnp.log2(jnp.maximum(p, 1e-9)), 1.0, 15.0),
            16.0,
        )
    # exact integer cluster histograms for the host's package-merge
    # (counts reach ~2^20; the GPU's default float32 matmul may run in
    # TF32, which would round them, so force full-f32 contraction)
    assign = jax.nn.one_hot(sel, K, dtype=jnp.float32)
    clhist = jnp.matmul(
        assign.T, hist_c, precision=jax.lax.Precision.HIGHEST
    ).astype(jnp.int32)
    return sel, clhist
