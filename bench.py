"""tpulc benchmark harness — prints ONE JSON line.

Corpus: the reference's own benchmark file reconstructed exactly.
`testdata/largefile` (3,569,598 bytes, out-of-tree in the reference)
is `pg1661.txt` (594,933 B, in-tree) repeated 6 times: 594933*6 =
3569598, and CPU libbsc 3.1.0 compresses our reconstruction to
EXACTLY the 159,230 bytes reported in `/root/reference/README.md:31`
— byte-identical corpus, so every reference number in BASELINE.md is
directly comparable.

Headline metric: compress+decompress throughput of the bzip2-class
pipeline per chip vs cuda-bzip2 on a V100 (3,569,598 B in 2.185 s
compress + 0.191 s decompress = 1.502 MB/s round-trip, BASELINE.md
rows 6-7) on the SAME corpus.

`--full` adds the per-codec matrix (bsc/huffman/lzss/culzss) on both
the pg corpus and the synthetic word-soup corpus.  The run fails (exit
1) when JAX's default device is not a GPU or when any row raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# V100 cuda-bzip2: 3,569,598 bytes in (2.185 + 0.191) s round-trip.
BASELINE_ROUNDTRIP_MBPS = 3.569598 / (2.185 + 0.191)
# V100 libbsc -G: 0.147 s compress + 0.215 s decompress, ratio 22.42
BASELINE_BSC_MBPS = 3.569598 / (0.147 + 0.215)
BASELINE_BSC_RATIO = 22.42

SIZE = 3_569_598  # the reference benchmark file size (BASELINE.md)


def make_corpus(size: int = SIZE) -> bytes:
    """The reference benchmark corpus: pg1661.txt repeated (see module
    docstring — byte-identical to the reference's `largefile`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "data", "pg1661.txt"), "rb") as f:
        raw = f.read()
    return (raw * (size // len(raw) + 1))[:size]


def make_soup(size: int = SIZE) -> bytes:
    """Deterministic word-soup text (the round-1 synthetic corpus,
    kept for continuity of BENCH_r01 comparisons)."""
    rng = np.random.default_rng(12345)
    words = [
        b"the", b"of", b"and", b"compression", b"lossless", b"entropy",
        b"transform", b"block", b"sorting", b"data", b"parallel", b"encode",
        b"decode", b"huffman", b"window", b"match", b"stream", b"symbol",
    ]
    parts = []
    total = 0
    while total < size:
        w = words[int(rng.integers(len(words)))]
        parts.append(w)
        parts.append(b" ")
        total += len(w) + 1
    return b"".join(parts)[:size]


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _progress(tag, obj):
    """Stream each completed section to stderr immediately — a crashed
    or killed run still leaves every finished row on record."""
    print("##", tag, json.dumps(obj), file=sys.stderr, flush=True)


def bench_huffman_decode_100mb(size: int = 100_000_000):
    """CUHD's headline setup (`/root/reference/README.md:107-117`:
    100 MB decoded in 1,520 us on a V100 == 66 GB/s): decode-only GB/s
    of the aligned batched rank decoder, device-resident, kernel time
    via block_until_ready.  Returns a dict with the honest number and
    its roofline position."""
    import jax
    import jax.numpy as jnp

    from tpulc.codecs.huffman import driver as hd

    data = make_corpus(size)
    bs = 1 << 20
    comp = hd.compress(data, block_size=bs)
    # correctness: full round trip through the container path
    out = hd.decompress(comp)
    assert out == data, "huffman 100MB round-trip mismatch"
    from tpulc.pipeline.container import Container

    c = Container.from_bytes(comp)
    nb = hd.max_batch()
    groups = [c.payloads[i: i + nb] for i in range(0, len(c.payloads), nb)]
    preps = []
    chunk = None
    for g in groups:
        words_a, tbits_a, lens_a, offs_a, ns, chunk = \
            hd._parse_aligned_group(g, bs, 12)
        preps.append((jnp.asarray(words_a), jnp.asarray(tbits_a),
                      jnp.asarray(lens_a), jnp.asarray(offs_a)))
    # warm (the decoder this backend uses: the chunk-walk kernel on
    # the GPU)
    for p in preps:
        hd.decode_batch_device(*p, chunk, 12).block_until_ready()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [hd.decode_batch_device(*p, chunk, 12) for p in preps]
        for o in outs:
            o.block_until_ready()
        reps.append(time.perf_counter() - t0)
    dec_s = _median(reps)
    return {
        "input_MB": round(size / 1e6, 1),
        "compressed_MB": round(len(comp) / 1e6, 1),
        "chunk_syms": chunk,
        "decode_kernel_s": round(dec_s, 4),
        "decode_GBps": round(size / 1e9 / dec_s, 3),
        "vs_cuhd_v100_66GBps": round(size / 1e9 / dec_s / 66.0, 4),
    }


def bench_roundtrip(codec_name: str, data: bytes, block_size: int,
                    repeats: int = 3, **kw):
    """Warm round trip, median of `repeats` (stable perf protocol —
    one noisy dispatch no longer defines a round's number)."""
    from tpulc.pipeline.registry import get_codec

    codec = get_codec(codec_name)
    # warmup/compile
    comp = codec.compress(data, block_size=block_size, **kw)
    out = codec.decompress(comp)
    assert out == data, "round-trip mismatch"
    cs, ds = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        comp = codec.compress(data, block_size=block_size, **kw)
        t1 = time.perf_counter()
        out = codec.decompress(comp)
        t2 = time.perf_counter()
        assert out == data
        cs.append(t1 - t0)
        ds.append(t2 - t1)
    c_s, d_s = _median(cs), _median(ds)
    return {
        "compress_s": c_s,
        "decompress_s": d_s,
        "repeats": repeats,
        "ratio": len(data) / len(comp),
        "roundtrip_mbps": len(data) / 1e6 / (c_s + d_s),
    }


def _row(detail: dict, failures: list, key: str, fn, *args, **kwargs):
    """detail[key] = fn(...); a raising row is recorded and fails the
    run at the end."""
    try:
        detail[key] = fn(*args, **kwargs)
    except Exception as e:
        detail[key] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
        failures.append(key)
    _progress(key, detail[key])


def _summary(r: dict, extra: bool = False) -> dict:
    out = {"MBps": round(r["roundtrip_mbps"], 3),
           "ratio": round(r["ratio"], 3)}
    if extra:
        out["compress_s"] = round(r["compress_s"], 2)
        out["decompress_s"] = round(r["decompress_s"], 2)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="tpulc benchmark")
    p.add_argument("--full", action="store_true",
                   help="add the 100 MB rows and the per-codec matrix")
    p.add_argument("--no-huff100", action="store_true",
                   help="skip the 100 MB Huffman decode row")
    args = p.parse_args(argv)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's default device is "
                 f"{dev.platform}")
    data = make_corpus(SIZE)
    r = bench_roundtrip("bz", data, block_size=900_000)
    metric = "bz_pipeline_roundtrip_MBps"
    value = r["roundtrip_mbps"]
    _progress(metric, {"MBps": round(value, 3), "ratio": round(r["ratio"], 3)})
    detail = {
        "corpus": "pg1661x6 == reference testdata/largefile",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "compress_s": round(r["compress_s"], 4),
        "decompress_s": round(r["decompress_s"], 4),
        "ratio": round(r["ratio"], 3),
        "input_bytes": SIZE,
        "protocol": {"timing": "median-of-%d, warm" % r["repeats"]},
    }
    failures = []

    def bsc_row(**kw):
        rb = bench_roundtrip("bsc", data, block_size=4 << 20, **kw)
        return {**_summary(rb),
                "vs_libbsc_MBps": round(
                    rb["roundtrip_mbps"] / BASELINE_BSC_MBPS, 3),
                "vs_libbsc_ratio": round(rb["ratio"] / BASELINE_BSC_RATIO, 3)}

    # bsc is the reference's strongest config (BASELINE.md rows 2-4).
    _row(detail, failures, "bsc", bsc_row)
    _row(detail, failures, "bsc_e2", bsc_row, coder=2)
    # CUHD-class decode throughput (BASELINE.md row 16).
    if not args.no_huff100:
        _row(detail, failures, "huffman_decode_100MB",
             bench_huffman_decode_100mb)
    if args.full:
        big = make_corpus(100_000_000)
        _row(detail, failures, "bz_100MB", lambda: _summary(
            bench_roundtrip("bz", big, block_size=900_000), extra=True))
        _row(detail, failures, "bsc_100MB", lambda: _summary(
            bench_roundtrip("bsc", big, block_size=25 << 20, repeats=1),
            extra=True))
        corpora = {"pg": data, "soup": make_soup(SIZE)}
        matrix = {}
        for cname, cdata in corpora.items():
            codecs = {}
            jobs = [("huffman", 1 << 20, {}), ("lzss", 1 << 20, {}),
                    ("culzss", 1 << 20, {}), ("bsc", 4 << 20, {}),
                    ("bsc_st8", 4 << 20, {"sorter": "st8"}),
                    ("bsc_e2", 4 << 20, {"coder": 2}),
                    ("bz", 900_000, {}),
                    ("bzip2", 900_000, {})]
            for name, bs, kw in jobs:
                _row(codecs, failures, f"{cname}.{name}",
                     lambda n=name, b=bs, k=kw: _summary(bench_roundtrip(
                         n.split("_")[0], cdata, block_size=b, **k)))
            matrix[cname] = codecs
        detail["codecs"] = matrix
    print(json.dumps({
        "metric": metric,
        "value": round(value, 3),
        "unit": "MB/s",
        "vs_baseline": round(value / BASELINE_ROUNDTRIP_MBPS, 3),
        "detail": detail,
    }))
    if failures:
        sys.exit(f"rows failed: {', '.join(failures)}")


if __name__ == "__main__":
    main()
