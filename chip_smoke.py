"""Smoke test of tpulc's main path on one NVIDIA GPU.

    python chip_smoke.py          # one card: every codec, memory, kernel
    python chip_smoke.py --four   # four cards: the sharded bz round trip

Phases, in order; any failure exits non-zero before the last line:

1. device  - the default JAX device must be a GPU; prints its kind,
             the device count and `nvidia-smi`'s name and power limit.
2. codecs  - `get_codec(name).compress/decompress` round trips at real
             block sizes, each bit-exact; `bzip2` must equal Python's
             `bz2.compress(data, 9)` and pass the gold C decoder; one
             CLI round trip through `tpulc.cli.main.main`.
3. memory  - `compiled.memory_analysis()` of the fused bz compress
             program and of the 25 MiB bsc block program, and the
             device's peak bytes in use.
4. kernel  - the Huffman chunk-walk kernel against the XLA rank decoder
             on a 100 MB input in 1 MiB blocks: end-to-end `decompress`
             with each, exact output, both times; the same for bz's
             walk at 900 KB blocks.

The last line of standard output is one JSON object:
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
All phases run in this one process; times are host clock around work
that ends on the host, first calls include compilation.
"""

from __future__ import annotations

import argparse
import bz2
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PG = os.path.join(HERE, "tests", "data", "pg1661.txt")
CORPUS_SIZE = 3_569_598      # pg1661.txt x6: the reference's benchmark file
BZ_BLOCK = 900_000
HUFF_BLOCK = 1 << 20


def log(*parts) -> None:
    print(*parts, flush=True)


def make_corpus(size: int = CORPUS_SIZE) -> bytes:
    """pg1661.txt repeated to `size` bytes."""
    with open(PG, "rb") as f:
        raw = f.read()
    return (raw * (size // len(raw) + 1))[:size]


def make_text(size: int, seed: int = 0) -> bytes:
    """Non-periodic text: words of pg1661.txt drawn independently with
    their corpus frequencies.  LZP finds no block-scale repeats in it,
    so the transform runs at the full block size."""
    import numpy as np

    with open(PG, "rb") as f:
        words = f.read().split()
    rng = np.random.default_rng(seed)
    out, total = [], 0
    while total < size:
        pick = rng.integers(0, len(words), size=max(1, size // 5))
        part = b" ".join(words[i] for i in pick) + b"\n"
        out.append(part)
        total += len(part)
    return b"".join(out)[:size]


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def phase_device(expect: int | None = None) -> dict:
    """Fail unless JAX's default device is a GPU; print what it is."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is "
                         f"{devs[0].platform!r}")
    if expect is not None and len(devs) < expect:
        raise SystemExit(f"need {expect} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"device: {info['kind']} x{info['count']}")
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    return info


def roundtrip(name: str, data: bytes, **kwargs) -> tuple[dict, bytes]:
    """One compress/decompress through the registry; raises unless the
    bytes come back exactly."""
    from tpulc.pipeline.registry import get_codec

    codec = get_codec(name)
    comp, t_c = _timed(codec.compress, data, **kwargs)
    back, t_d = _timed(codec.decompress, comp)
    if back != data:
        raise AssertionError(f"{name} {kwargs}: round trip not exact")
    row = {"codec": name, "bytes": len(data), "comp": len(comp),
           "compress_s": t_c, "decompress_s": t_d, **kwargs}
    log(f"codec {name} {kwargs}: {len(data)} -> {len(comp)} bytes "
        f"(ratio {len(data) / max(len(comp), 1):.3f}), compress "
        f"{t_c:.3f} s, decompress {t_d:.3f} s, exact")
    return row, comp


def check_bzip2(data: bytes) -> dict:
    """`bzip2` output must equal bz2.compress(data, 9) and decode with
    the gold C decoder."""
    from tpulc.gold.lzss_gold import bz2_decompress

    row, comp = roundtrip("bzip2", data, block_size=900_000)
    if comp != bz2.compress(data, 9):
        raise AssertionError("bzip2 output differs from bz2.compress(data, 9)")
    if bz2_decompress(comp, len(data)) != data:
        raise AssertionError("gold decoder rejected the bzip2 stream")
    log("codec bzip2: byte-identical to bz2.compress(data, 9); "
        "gold decoder accepts")
    return row


def check_cli(data: bytes, block_size: int, codec: str = "bz") -> None:
    """One compress/decompress through the CLI entry point."""
    from tpulc.cli.main import main

    with tempfile.TemporaryDirectory() as d:
        src, packed, back = (os.path.join(d, n) for n in ("in", "c", "out"))
        with open(src, "wb") as f:
            f.write(data)
        if main(["compress", "-c", codec, "-i", src, "-o", packed,
                 "-b", str(block_size)]) != 0:
            raise AssertionError("cli compress failed")
        if main(["decompress", "-i", packed, "-o", back]) != 0:
            raise AssertionError("cli decompress failed")
        with open(back, "rb") as f:
            if f.read() != data:
                raise AssertionError("cli round trip not exact")
    log(f"cli {codec}: round trip exact")


def phase_codecs(corpus: bytes, text: bytes, bsc_block: int,
                 e2_block: int, bz_block: int = BZ_BLOCK,
                 huff_block: int = HUFF_BLOCK) -> list:
    """Every codec through `get_codec` at its real block size (lzss and
    culzss at their defaults)."""
    rows = [roundtrip("bz", corpus, block_size=bz_block)[0],
            check_bzip2(corpus),
            roundtrip("bsc", text[:bsc_block], block_size=bsc_block)[0],
            roundtrip("bsc", text[:2 * e2_block], block_size=e2_block,
                      coder=2)[0],
            roundtrip("huffman", corpus, block_size=huff_block)[0],
            roundtrip("lzss", corpus)[0],
            roundtrip("culzss", corpus)[0]]
    check_cli(corpus, bz_block)
    return rows


def _mem(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def phase_memory(bsc_block: int, bz_block: int = BZ_BLOCK) -> dict:
    """Compiled memory of the two largest programs, and the peak."""
    import jax
    import jax.numpy as jnp

    from tpulc.codecs.bsclike import driver as bsc
    from tpulc.codecs.bwt import driver as bz

    cap = bz._cap_for(bz_block)
    fused = bz._compress_fused.lower(
        jnp.zeros(cap, jnp.uint8), -(-cap // bz.ANCHOR_STRIDE), 6,
        -(-cap * bz.MAX_LEN // 32), -(-cap // bz.CHUNK_SYMS)).compile()
    bcap = bsc._cap_for(bsc_block)
    block = bsc._fwd_packed.lower(
        jnp.zeros(bcap, jnp.uint8), jnp.int32(bcap)).compile()
    out = {"bz_compress_fused": _mem(fused),
           "bsc_block_transform": _mem(block)}
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    for k, v in out.items():
        log(f"memory {k}: {json.dumps(v)}")
    return out


def _median_time(fn, *args, n: int = 3) -> float:
    fn(*args)                               # compile / warm
    return sorted(_timed(fn, *args)[1] for _ in range(n))[n // 2]


def phase_kernel(huff_bytes: int, corpus: bytes, bz_block: int = BZ_BLOCK,
                 huff_block: int = HUFF_BLOCK) -> dict:
    """The chunk-walk kernel against the XLA forms: warm end-to-end
    `decompress`, median of 3 each, outputs exact."""
    import jax

    from tpulc.codecs.bwt import driver as bz
    from tpulc.codecs.huffman import driver as hd

    out = {}
    data = make_corpus(huff_bytes)
    comp = hd.compress(data, block_size=huff_block)
    kernel = hd.decode_batch_device
    xla = hd._decode_batch_ranks
    if hd.decompress(comp) != data:
        raise AssertionError("huffman kernel decode differs from input")
    t_k = _median_time(hd.decompress, comp)
    hd.decode_batch_device = xla
    try:
        if hd.decompress(comp) != data:
            raise AssertionError("huffman XLA decode differs from input")
        t_x = _median_time(hd.decompress, comp)
    finally:
        hd.decode_batch_device = kernel
    out["huffman"] = {"bytes": len(data), "kernel_s": t_k, "xla_s": t_x}
    log(f"kernel huffman {len(data)} B in {-(-len(data) // huff_block)} "
        f"blocks: decompress with kernel {t_k:.4f} s, with XLA rank "
        f"decoder {t_x:.4f} s (medians of 3), both exact")

    comp = bz.compress(corpus, block_size=bz_block)
    if bz.decompress(comp) != corpus:
        raise AssertionError("bz kernel decode differs from input")
    t_k = _median_time(bz.decompress, comp)
    on_gpu = bz.on_gpu
    bz.on_gpu = lambda: False               # the XLA walk, retraced
    jax.clear_caches()
    try:
        if bz.decompress(comp) != corpus:
            raise AssertionError("bz XLA decode differs from input")
        t_x = _median_time(bz.decompress, comp)
    finally:
        bz.on_gpu = on_gpu
        jax.clear_caches()
    out["bz"] = {"bytes": len(corpus), "kernel_s": t_k, "xla_s": t_x}
    log(f"kernel bz {len(corpus)} B: decompress with kernel {t_k:.4f} s, "
        f"with XLA LUT walk {t_x:.4f} s (medians of 3), both exact")
    return out


def phase_four(blocks_per_card: int = 2, block: int = BZ_BLOCK) -> None:
    """The sharded bz round trip over a 4-card mesh, against the input
    and against the same transform on one card."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from tpulc.codecs.bwt.driver import _cap_for
    from tpulc.dist.mesh import BLOCKS_AXIS, make_mesh
    from tpulc.dist.sharded import bz_roundtrip_one, sharded_bz_roundtrip

    n = 4 * blocks_per_card
    cap = _cap_for(block)
    raw = np.frombuffer(make_corpus(n * block), np.uint8)
    blocks = np.zeros((n, cap), np.uint8)
    blocks[:, :block] = raw.reshape(n, block)
    mesh = make_mesh(4)
    step, _ = sharded_bz_roundtrip(mesh, block)
    mesh_in = jax.device_put(
        blocks, NamedSharding(mesh, PartitionSpec(BLOCKS_AXIS, None)))
    (back, sizes), t_first = _timed(
        lambda: jax.block_until_ready(step(mesh_in)))
    (back, sizes), t_warm = _timed(
        lambda: jax.block_until_ready(step(mesh_in)))
    one = jax.jit(jax.vmap(bz_roundtrip_one))
    ref_back, ref_m = jax.block_until_ready(
        one(jax.device_put(blocks, jax.devices()[0])))
    back, sizes = np.asarray(back), np.asarray(sizes)
    if not np.array_equal(back, blocks):
        raise AssertionError("sharded bz round trip differs from input")
    if not (np.array_equal(back, np.asarray(ref_back))
            and np.array_equal(sizes, np.asarray(ref_m))):
        raise AssertionError("sharded bz differs from the one-card "
                             "transform")
    log(f"four: sharded bz round trip of {n} x {block} B blocks on "
        f"4 cards: first {t_first:.3f} s, warm {t_warm:.3f} s; equal to "
        f"input and to the one-card transform")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card sharded bz round trip")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "tpulc")) \
            or not os.path.exists(PG):
        raise SystemExit("chip_smoke.py must run from a tpulc checkout")
    sys.path.insert(0, HERE)
    import tpulc  # noqa: F401  (compile cache set-up)

    info = phase_device(4 if args.four else None)
    if args.four:
        phase_four()
    else:
        from tpulc.codecs.bsclike.driver import DEFAULT_BLOCK

        corpus = make_corpus()
        text = make_text(DEFAULT_BLOCK)
        phase_codecs(corpus, text, DEFAULT_BLOCK, 4 << 20)
        phase_memory(DEFAULT_BLOCK)
        phase_kernel(100_000_000, corpus)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
