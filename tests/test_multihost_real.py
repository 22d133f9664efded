"""REAL multi-process multihost run (2 processes over localhost gRPC).

Upgrades the multi-host story from single-process unit tests to an
actual `jax.distributed.initialize` run: two OS processes form a
2-process JAX runtime on the CPU backend, each compresses its block
stripe (`dist/multihost.py`), payloads gather to process 0 over the
distributed runtime (the DCN role), and the assembled container must
decompress to the original bytes in the parent.
"""

import os
import socket
import subprocess
import sys
import tempfile

import pytest

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
port, pid, data_f, out_f = sys.argv[1:5]
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=2,
    process_id=int(pid),
)
assert jax.process_count() == 2
from tpulc.dist.multihost import compress_multihost
with open(data_f, "rb") as f:
    data = f.read()
out = compress_multihost(data, block_size=8192, codec_name="huffman")
if out is not None:
    with open(out_f, "wb") as f:
        f.write(out)
jax.distributed.shutdown()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_multihost_roundtrip(tmp_path):
    with open("tests/data/pg1661.txt", "rb") as f:
        data = f.read()[:40000]
    data_f = tmp_path / "in.bin"
    data_f.write_bytes(data)
    out_f = tmp_path / "out.tplc"
    port = _free_port()

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(port), str(i),
             str(data_f), str(out_f)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=560) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    blob = out_f.read_bytes()

    from tpulc.pipeline.registry import get_codec

    assert get_codec("huffman").decompress(blob) == data
