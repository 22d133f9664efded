"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR is used as
given; without it, the checkout's .jax_cache (per machine on the CPU)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
          "import tpulc; print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(extra_env):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(extra_env, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


def test_env_dir_is_used_as_given(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_default_is_checkout_partition():
    got = _cache_dir({})
    assert os.path.dirname(got) == os.path.join(ROOT, ".jax_cache")
    assert os.path.basename(got).startswith("m-")
