"""CLI end-to-end matrix: every codec round-trips through the CLI."""

import os
import subprocess

import numpy as np
import pytest

from tpulc.cli.main import main


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    with open("tests/data/pg1661.txt", "rb") as f:
        base = f.read()[:40000]
    data = base + base[:10000]
    p = d / "in.dat"
    p.write_bytes(data)
    return d, p, data


@pytest.mark.parametrize(
    "codec", ["store", "huffman", "lzss", "culzss", "bz", "bsc", "bzip2"]
)
def test_cli_roundtrip(codec, corpus):
    d, p, data = corpus
    out = d / f"out.{codec}"
    back = d / f"back.{codec}"
    main(["compress", "-c", codec, "-i", str(p), "-o", str(out),
          "-b", "32768"])
    main(["decompress", "-i", str(out), "-o", str(back)])
    assert back.read_bytes() == data, codec


def test_cli_lzss_exact_flag(corpus):
    d, p, data = corpus
    out = d / "out.exact"
    main(["compress", "-c", "lzss", "--exact", "-i", str(p), "-o",
          str(out), "-b", "65536"])
    back = d / "back.exact"
    main(["decompress", "-i", str(out), "-o", str(back)])
    assert back.read_bytes() == data


def test_cli_bsc_nolzp(corpus):
    d, p, data = corpus
    out = d / "out.nolzp"
    main(["compress", "-c", "bsc", "--no-lzp", "-i", str(p), "-o",
          str(out), "-b", "32768"])
    back = d / "back.nolzp"
    main(["decompress", "-i", str(out), "-o", str(back)])
    assert back.read_bytes() == data


def test_cli_info(tmp_path):
    """`info` inspects a container without decoding (bsc_block_info
    role): codec name, block table, checksums."""
    import json

    data = b"to be or not to be " * 400
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.tplc"
    main(["compress", "-c", "huffman", "-i", str(src), "-o", str(dst),
          "-b", "4096"])
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["info", "-i", str(dst)]) == 0
    info = json.loads(buf.getvalue())
    assert info["codec"] == "huffman"
    assert info["orig_len"] == len(data)
    assert info["nblocks"] == len(info["blocks"])
    assert sum(b["comp_size"] for b in info["blocks"]) <= info["comp_len"]
