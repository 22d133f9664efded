"""shard_map'ed block-parallel codec steps.

Maps the reference's host-thread block schedulers (bzip2 all-core OpenMP
`compress.c:876-1006`, bsc block loop `bsc.cpp:206`, CULZSS ring
`culzss.c:73`) onto a device mesh: each device owns a slice of the
blocks; shared-dictionary mode builds one global histogram with `psum`
and encodes every block with the broadcast table (BASELINE config 5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# check_vma=False: all_gather/psum results are replicated by
# construction; the static replication checker cannot always infer it.
shard_map = partial(jax.shard_map, check_vma=False)

from tpulc.dist.mesh import BLOCKS_AXIS
from tpulc.primitives.bits import pack_bits


def _masked_encode(block, n, codes, lengths, out_words: int):
    idx = block.astype(jnp.int32)
    valid = jnp.arange(block.shape[0], dtype=jnp.int32) < n
    sym_lens = jnp.where(valid, lengths[idx], 0)
    sym_codes = jnp.where(valid, codes[idx], 0).astype(jnp.uint32)
    return pack_bits(sym_codes, sym_lens, out_words)


def _masked_hist(block, n):
    idx = jnp.where(
        jnp.arange(block.shape[0], dtype=jnp.int32) < n,
        block.astype(jnp.int32),
        256,
    )
    return jnp.zeros((257,), jnp.int32).at[idx].add(1, mode="drop")[:256]


def global_histogram(mesh: Mesh, blocks: jax.Array, ns: jax.Array) -> jax.Array:
    """Global 256-bin histogram of sharded blocks via psum.

    blocks: uint8[B, block_size] sharded over 'blocks'; ns: int32[B].
    Returns a replicated int32[256] — the shared-dictionary histogram
    that the host turns into one broadcast Huffman table.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS)),
        out_specs=P(),
    )
    def step(local_blocks, local_ns):
        h = jnp.sum(jax.vmap(_masked_hist)(local_blocks, local_ns), axis=0)
        return jax.lax.psum(h, BLOCKS_AXIS)

    return jax.jit(step)(blocks, ns)


def sharded_huffman_encode(
    mesh: Mesh,
    blocks: jax.Array,
    ns: jax.Array,
    codes: jax.Array,
    lengths: jax.Array,
    out_words: int,
):
    """Encode all blocks with a shared (replicated) table.

    Returns (words uint32[B, out_words] sharded, bits int32[B] replicated).
    The all_gather of per-block bit counts is the offset-table collective
    (SURVEY.md §5 'distributed communication backend').
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS), P(None), P(None)),
        out_specs=(P(BLOCKS_AXIS, None), P()),
    )
    def step(local_blocks, local_ns, codes_, lengths_):
        words, bits = jax.vmap(
            lambda b, n: _masked_encode(b, n, codes_, lengths_, out_words)
        )(local_blocks, local_ns)
        all_bits = jax.lax.all_gather(bits, BLOCKS_AXIS, tiled=True)
        return words, all_bits

    return jax.jit(step)(blocks, ns, codes, lengths)


def sharded_huffman_roundtrip_step(mesh: Mesh, block_size: int, max_len: int = 12):
    """Build the full jitted multi-chip step used by dryrun_multichip.

    One step = per-block masked histogram -> psum global histogram ->
    encode every block with a (replicated) table -> all_gather sizes.
    The table itself is an input (host builds it from the histogram
    between the two jitted stages in the real pipeline); here it is
    exercised in a single program to validate shardings end to end.
    """
    out_words = -(-block_size * max_len // 32)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS), P(None), P(None)),
        out_specs=(P(), P(BLOCKS_AXIS, None), P()),
    )
    def step(local_blocks, local_ns, codes_, lengths_):
        h = jnp.sum(jax.vmap(_masked_hist)(local_blocks, local_ns), axis=0)
        ghist = jax.lax.psum(h, BLOCKS_AXIS)
        words, bits = jax.vmap(
            lambda b, n: _masked_encode(b, n, codes_, lengths_, out_words)
        )(local_blocks, local_ns)
        all_bits = jax.lax.all_gather(bits, BLOCKS_AXIS, tiled=True)
        return ghist, words, all_bits

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 256, size=(n_blocks, block_size)).astype(np.uint8)
        ns = np.full((n_blocks,), block_size, np.int32)
        # trivial valid table: 8-bit flat code
        codes = np.arange(256, dtype=np.uint32)
        lengths = np.full((256,), 8, np.int32)
        sharding = NamedSharding(mesh, P(BLOCKS_AXIS, None))
        return (
            jax.device_put(blocks, sharding),
            jax.device_put(ns, NamedSharding(mesh, P(BLOCKS_AXIS))),
            jax.device_put(codes, NamedSharding(mesh, P())),
            jax.device_put(lengths.astype(np.int32), NamedSharding(mesh, P())),
        )

    return jax.jit(step), make_args


def sharded_bz_forward(mesh: Mesh, block_size: int):
    """Block-data-parallel bz transform step over the mesh.

    Each device runs the full BWT -> MTF -> RLE2 transform on its local
    blocks (embarrassingly parallel, like bzip2's all-core scheduler
    `compress.c:876-1006`); the all_gather of per-block symbol counts
    is the container offset-table collective.  Returns a jitted step
    and an argument builder.
    """
    from tpulc.codecs.bwt.driver import _cap_for, _forward

    cap = _cap_for(block_size)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(BLOCKS_AXIS, None),
        out_specs=(
            P(BLOCKS_AXIS, None),  # syms
            P(BLOCKS_AXIS),        # m
            P(BLOCKS_AXIS),        # idx0
            P(BLOCKS_AXIS, None),  # hist (per block)
            P(BLOCKS_AXIS, None),  # anchors
            P(BLOCKS_AXIS),        # anchors_ok
            P(),                   # gathered sizes (offset table)
        ),
    )
    def step(local_blocks):
        syms, m, idx0, hist, anchors, ok = jax.vmap(_forward)(local_blocks)
        sizes = jax.lax.all_gather(m, BLOCKS_AXIS, tiled=True)
        return syms, m, idx0, hist, anchors, ok, sizes

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 64, size=(n_blocks, cap)).astype(np.uint8)
        return (
            jax.device_put(
                blocks, NamedSharding(mesh, P(BLOCKS_AXIS, None))
            ),
        )

    return jax.jit(step), make_args


def bz_roundtrip_one(block):
    """bz transform of one padded block and its inverse:
    (reconstructed block, RLE2 symbol count)."""
    from tpulc.codecs.bwt.driver import _forward
    from tpulc.codecs.bwt.rle import rle2_decode
    from tpulc.codecs.bwt.rotsort import bwt_decode
    from tpulc.primitives.mtf import mtf_decode

    syms, m, idx0, hist, anchors, ok = _forward(block)
    ranks, _ = rle2_decode(syms, m)
    last = mtf_decode(ranks)
    return bwt_decode(last, idx0), m


def sharded_bz_roundtrip(mesh: Mesh, block_size: int):
    """Sharded forward AND inverse of the bz transform in one program.

    Each device inverts its own blocks (RLE2 -> MTF -> IBWT) after the
    forward, and the program returns the reconstructed blocks so the
    caller can assert sharded-decode == original bytes.  The collective
    set matches the real pipeline: all_gather of per-block sizes.
    """
    from tpulc.codecs.bwt.driver import _cap_for

    cap = _cap_for(block_size)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(BLOCKS_AXIS, None),
        out_specs=(P(BLOCKS_AXIS, None), P()),
    )
    def step(local_blocks):
        back, m = jax.vmap(bz_roundtrip_one)(local_blocks)
        sizes = jax.lax.all_gather(m, BLOCKS_AXIS, tiled=True)
        return back, sizes

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 64, size=(n_blocks, cap)).astype(np.uint8)
        return (
            jax.device_put(
                blocks, NamedSharding(mesh, P(BLOCKS_AXIS, None))
            ),
        )

    return jax.jit(step), make_args


def sharded_bsc_rans_forward(mesh: Mesh, block_size: int):
    """Sharded bsc-class forward: masked BWT pipeline + order-2 context
    rANS lanes per block, tables replicated (the broadcast-table role
    of BASELINE config 5), all_gather of per-block word counts as the
    container offset collective.
    """
    from tpulc.codecs.bsclike.driver import _cap_for as _bsc_cap
    from tpulc.codecs.bsclike.rans import CHUNK, ctx_of_stream, rans_encode_ctx
    from tpulc.codecs.bwt.masked import forward_masked

    cap = _bsc_cap(block_size)

    def _one(block, n, freq, cum):
        syms, m, idx0, hist = forward_masked(block, n)
        ctx = ctx_of_stream(syms)
        words, counts, states = rans_encode_ctx(syms, ctx, m, freq, cum,
                                                chunk=CHUNK)
        return counts.sum(), m

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS), P(None, None),
                  P(None, None)),
        out_specs=(P(), P()),
    )
    def step(local_blocks, local_ns, freq, cum):
        nwords, m = jax.vmap(
            lambda b, n: _one(b, n, freq, cum)
        )(local_blocks, local_ns)
        all_words = jax.lax.all_gather(nwords, BLOCKS_AXIS, tiled=True)
        all_m = jax.lax.all_gather(m, BLOCKS_AXIS, tiled=True)
        return all_words, all_m

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        from tpulc.codecs.bsclike.rans import (
            NCTX,
            normalize_freqs_ctx,
        )
        from tpulc.codecs.bwt.rle import ALPHABET

        rng = np.random.default_rng(rng_seed)
        blocks = rng.integers(0, 64, size=(n_blocks, cap)).astype(np.uint8)
        ns = np.full((n_blocks,), block_size, np.int32)
        # uniform replicated tables: every symbol present -> decodable
        fq = normalize_freqs_ctx(np.ones((NCTX, ALPHABET), np.int64))
        cum = np.concatenate(
            [np.zeros((NCTX, 1), np.int32),
             np.cumsum(fq, axis=1)[:, :-1].astype(np.int32)],
            axis=1,
        )
        return (
            jax.device_put(blocks, NamedSharding(mesh, P(BLOCKS_AXIS, None))),
            jax.device_put(ns, NamedSharding(mesh, P(BLOCKS_AXIS))),
            jax.device_put(fq.astype(np.int32), NamedSharding(mesh, P())),
            jax.device_put(cum, NamedSharding(mesh, P())),
        )

    return jax.jit(step), make_args


def sharded_abc_roundtrip(mesh: Mesh, block_size: int):
    """Sharded adaptive-binary-coder round trip (the ABC coder — wire
    id 2, shipped for ST-sorter -e2 blocks and legacy streams; BWT -e2
    blocks use the group-rank coder, whose lanes shard identically):
    each device
    encodes AND decodes its local blocks' symbol streams with a
    replicated model-init table (the broadcast-table role), then
    all_gathers per-block word counts (the container-offsets
    collective).  Covers the coder the bsc `-e2` path ships, on the
    mesh."""
    from tpulc.codecs.bsclike.driver import _cap_for as _bsc_cap
    from tpulc.codecs.bsclike.rans_adaptive import (
        ACHUNK,
        MAX_SYM_BITS,
        abc_decode,
        abc_encode,
        abc_stats,
    )

    cap = _bsc_cap(block_size)
    W = MAX_SYM_BITS * ACHUNK  # hard upper bound on bits per lane

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS), P(None, None)),
        out_specs=(P(BLOCKS_AXIS, None), P()),
    )
    def step(local_syms, local_ns, inits):
        lB = local_syms.shape[0]
        inits_l = jnp.broadcast_to(inits, (lB, inits.shape[1]))
        _, _, lane_bits, lane_cls = abc_stats(local_syms, local_ns)
        words, counts, states = abc_encode(
            local_syms, local_ns, inits_l, W
        )
        out = abc_decode(
            words, counts, states, lane_cls, local_ns, inits_l,
            jnp.max(lane_bits), B=lB,
        )
        nwords = counts.reshape(lB, -1).sum(axis=1)
        all_words = jax.lax.all_gather(nwords, BLOCKS_AXIS, tiled=True)
        return out, all_words

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        syms = np.minimum(
            rng.geometric(0.4, size=(n_blocks, cap)) - 1, 256
        ).astype(np.int32)
        ns = np.full((n_blocks,), cap, np.int32)
        from tpulc.codecs.bsclike.rans_adaptive import NMODELS

        inits = np.full((1, NMODELS), 2048, np.uint16)
        return (
            jax.device_put(syms, NamedSharding(mesh, P(BLOCKS_AXIS, None))),
            jax.device_put(ns, NamedSharding(mesh, P(BLOCKS_AXIS))),
            jax.device_put(inits, NamedSharding(mesh, P(None, None))),
        )

    return jax.jit(step), make_args


def sharded_grc_roundtrip(mesh: Mesh, block_size: int):
    """Sharded group-rank-coder (-e2 on BWT) round trip: each device
    encodes AND decodes its local blocks' MTF rank streams (grc.py) —
    the coder's inits are computed on-device per block and the per-
    block word counts all_gather for the container offsets table."""
    from tpulc.codecs.bsclike.driver import _cap_for as _bsc_cap
    from tpulc.codecs.bsclike.grc import (
        GCHUNK,
        grc_decode,
        grc_encode,
        grc_lane_bits,
    )

    cap = min(_bsc_cap(block_size), 4 * GCHUNK)
    # Hard bits-per-lane bound: grc_encode scatters with mode='drop',
    # so an undersized W silently truncates words.  MAX_GROUP_BITS per
    # group x GCHUNK groups/lane is the coder's true ceiling and is
    # tiny at dryrun shapes.
    from tpulc.codecs.bsclike.grc import MAX_GROUP_BITS
    W = MAX_GROUP_BITS * GCHUNK

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(BLOCKS_AXIS, None), P(BLOCKS_AXIS)),
        out_specs=(P(BLOCKS_AXIS, None), P()),
    )
    def step(local_ranks, local_ns):
        lB = local_ranks.shape[0]
        outs = []
        nw = []
        for b in range(lB):
            r = local_ranks[b]
            n = local_ns[b]
            words, counts, states, inits, cinits, _tot = grc_encode(
                r, n, W)
            lane_bits, _nstarts = grc_lane_bits(r, n)
            dec = grc_decode(
                words, counts, states, n, inits, cinits,
                jnp.max(lane_bits), cap)
            outs.append(dec)
            nw.append(counts.sum())
        out = jnp.stack(outs)
        all_words = jax.lax.all_gather(
            jnp.stack(nw), BLOCKS_AXIS, tiled=True)
        return out, all_words

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        ranks = np.where(
            rng.random((n_blocks, cap)) < 0.5, 0,
            np.minimum(rng.geometric(0.4, size=(n_blocks, cap)), 255),
        ).astype(np.int32)
        ns = np.full((n_blocks,), cap, np.int32)
        return (
            jax.device_put(ranks,
                           NamedSharding(mesh, P(BLOCKS_AXIS, None))),
            jax.device_put(ns, NamedSharding(mesh, P(BLOCKS_AXIS))),
        )

    return jax.jit(step), make_args


def sharded_culzss_roundtrip(mesh: Mesh, block_size: int):
    """Sharded CULZSS packet codec round trip (VERDICT r4 weak #7: the
    dryrun covered no LZ-family program).  Each device encodes its
    blocks' packets (full 128-offset window search) and decodes them
    back with the orbit-enumeration parallel decoder; the packet-size
    table rides an all_gather (the bookkeeping-header collective of
    `culzss.c:73`'s ring buffer).  block_size must be a multiple of the
    packet size (`culzss.PCKT`)."""
    from tpulc.codecs.lzss.culzss import (
        PCKT,
        culzss_decode_block,
        culzss_encode_block,
    )

    assert block_size % PCKT == 0

    def _one(block):
        pbuf, sizes, ntok = culzss_encode_block(block)
        dec, outl = culzss_decode_block(pbuf, sizes)
        return dec.reshape(block.shape[0]), jnp.sum(sizes)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(BLOCKS_AXIS, None),
        out_specs=(P(BLOCKS_AXIS, None), P()),
    )
    def step(local_blocks):
        back, csize = jax.vmap(_one)(local_blocks)
        sizes = jax.lax.all_gather(csize, BLOCKS_AXIS, tiled=True)
        return back, sizes

    def make_args(n_blocks: int, rng_seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        words = [b"the ", b"lzss ", b"window ", b"match ", b"stream "]
        buf = b"".join(words[int(i)] for i in
                       rng.integers(0, 5, size=n_blocks * block_size // 4))
        blocks = np.frombuffer(
            buf[: n_blocks * block_size], np.uint8
        ).reshape(n_blocks, block_size)
        return (
            jax.device_put(
                blocks, NamedSharding(mesh, P(BLOCKS_AXIS, None))
            ),
        )

    return jax.jit(step), make_args
