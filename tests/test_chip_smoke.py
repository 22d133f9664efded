"""chip_smoke.py's phases at tiny sizes on the CPU (imported, not run
as a script), and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device()


def test_script_exits_nonzero_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu",
                            "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_inputs_are_deterministic():
    assert len(cs.make_corpus()) == cs.CORPUS_SIZE
    a, b = cs.make_text(5000, seed=1), cs.make_text(5000, seed=1)
    assert a == b and len(a) == 5000 and a != cs.make_text(5000, seed=2)


def test_codec_phase_tiny(capsys):
    corpus = cs.make_corpus(12_000)
    text = cs.make_text(20_000)
    rows = cs.phase_codecs(corpus, text, bsc_block=16384, e2_block=8192,
                           bz_block=8192, huff_block=4096)
    assert [r["codec"] for r in rows] == [
        "bz", "bzip2", "bsc", "bsc", "huffman", "lzss", "culzss"]
    assert "byte-identical" in capsys.readouterr().out


def test_memory_and_kernel_phases_tiny():
    mem = cs.phase_memory(bsc_block=8192, bz_block=4096)
    assert mem["bz_compress_fused"]["temp_size_in_bytes"] > 0
    out = cs.phase_kernel(20_000, cs.make_corpus(9000), bz_block=4096,
                          huff_block=4096)
    assert set(out) == {"huffman", "bz"}
    assert all(v["kernel_s"] > 0 and v["xla_s"] > 0 for v in out.values())


def test_four_card_phase_tiny(capsys):
    """The --four path on four of the suite's virtual CPU devices."""
    cs.phase_four(blocks_per_card=2, block=4096)
    assert "equal to input and to the one-card transform" in \
        capsys.readouterr().out
