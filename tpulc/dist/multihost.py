"""Multi-host block-parallel compression with host-0 container assembly.

SURVEY.md §2.7's JAX-native communication backend, extended across
hosts: `jax.distributed.initialize` starts the runtime, each process
compresses the block stripe it owns (blocks are embarrassingly
parallel — the bzip2 all-core scheduler's `compress.c:876-1006` role),
and the compressed payloads gather to process 0 over DCN for ordered
container assembly.  Per-block payloads are self-contained, so the
only cross-host traffic is the final gather — the distributed analogue
of CULZSS's single-writer `cpu_sender` stage (`culzss.c:204-268`).

Variable-size payloads ride the gather as (sizes, padded bytes):
`process_allgather` needs uniform shapes, so each host pads its
payload buffer to the global maximum (sizes gather first).
"""

from __future__ import annotations

import numpy as np

from tpulc.pipeline.container import Container
from tpulc.primitives.checksum import adler32_np


def block_owner(block_idx: int, n_procs: int) -> int:
    """Contiguous stripes: block b belongs to process b % n_procs.

    Round-robin balances stripe sizes when the block count is not a
    multiple of the host count (the reference's atomic-counter work
    queue, `compress.c:914-919`, degenerates to this static schedule
    because the hosts are homogeneous)."""
    return block_idx % n_procs


def local_block_indices(n_blocks: int, proc: int, n_procs: int) -> list[int]:
    return [b for b in range(n_blocks) if block_owner(b, n_procs) == proc]


def assemble_container(
    codec_id: int,
    orig_len: int,
    block_size: int,
    n_blocks: int,
    per_proc_payloads: list[list[bytes]],
    data_adler: int,
) -> bytes:
    """Order per-process payload lists back into block order and build
    the container (host-0 side of the gather)."""
    n_procs = len(per_proc_payloads)
    ordered: list[bytes | None] = [None] * n_blocks
    cursors = [0] * n_procs
    for b in range(n_blocks):
        p = block_owner(b, n_procs)
        ordered[b] = per_proc_payloads[p][cursors[p]]
        cursors[p] += 1
    assert all(x is not None for x in ordered)
    c = Container(
        codec_id=codec_id, flags=0, orig_len=orig_len,
        block_size=block_size,
        comp_sizes=[len(p) for p in ordered],
        payloads=ordered, data_adler=data_adler,
    )
    return c.to_bytes()


def _gather_payload_lists(local_payloads: list[bytes]) -> list[list[bytes]]:
    """All-gather variable-size payload lists across processes.

    Uses `multihost_utils.process_allgather` on (counts, sizes, padded
    bytes).  Single-process runs short-circuit (unit-testable without a
    pod)."""
    import jax

    n_procs = jax.process_count()
    if n_procs == 1:
        return [local_payloads]

    from jax.experimental import multihost_utils as mh

    counts = mh.process_allgather(
        np.asarray([len(local_payloads)], np.int32)
    ).reshape(-1)
    max_count = int(counts.max())
    sizes = np.zeros(max_count, np.int64)
    sizes[: len(local_payloads)] = [len(p) for p in local_payloads]
    all_sizes = mh.process_allgather(sizes)          # [P, max_count]
    max_size = int(all_sizes.max())
    buf = np.zeros((max_count, max_size), np.uint8)
    for i, p in enumerate(local_payloads):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    all_buf = mh.process_allgather(buf)              # [P, max_count, max]
    out: list[list[bytes]] = []
    for pidx in range(n_procs):
        out.append([
            all_buf[pidx, i, : int(all_sizes[pidx, i])].tobytes()
            for i in range(int(counts[pidx]))
        ])
    return out


def compress_multihost(data: bytes | np.ndarray,
                       block_size: int = 900_000,
                       codec_name: str = "bz") -> bytes | None:
    """Compress `data` with each host handling its block stripe.

    Every process must call this with identical arguments (SPMD).
    Returns the container on process 0, None elsewhere.
    """
    import jax

    from tpulc.pipeline.registry import get_codec, codec_id_of

    arr = np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data, np.uint8)
    n = arr.shape[0]
    n_blocks = max(1, -(-n // block_size))
    proc = jax.process_index()
    n_procs = jax.process_count()
    codec = get_codec(codec_name)

    local = []
    for b in local_block_indices(n_blocks, proc, n_procs):
        chunk = arr[b * block_size: (b + 1) * block_size]
        # single-block container -> extract its payload
        sub = Container.from_bytes(
            codec.compress(chunk.tobytes(), block_size=block_size)
        )
        assert len(sub.payloads) == 1
        local.append(sub.payloads[0])

    gathered = _gather_payload_lists(local)
    if proc != 0:
        return None
    return assemble_container(
        codec_id_of(codec_name), n, block_size, n_blocks, gathered,
        adler32_np(arr),
    )
