"""tpulc — lossless compression framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities surveyed in
dingwentao/GPU-lossless-compression (see SURVEY.md):

- LZSS sliding-window codecs (CULZSS flag-byte and Dipperstein bitstream
  wire formats),
- canonical length-limited Huffman encoding with a fully parallel,
  self-synchronizing decoder (a scan-composition reformulation of the
  CUHD gap-array algorithm),
- the block-sorting family: BWT (rotation sort / sort-transform),
  MTF-as-a-scan, RLE, and bzip2-compatible entropy coding,
- a bsc-class large-block path (LZP + QLFC-rank + interleaved rANS).

Everything on the compute path is jittable JAX (lax.sort,
lax.associative_scan, scatter/gather bit packing, a Pallas kernel for the
Huffman chunk walk on the GPU); blocks shard data-parallel over a
`jax.sharding.Mesh`.
"""

__version__ = "0.1.0"


def _enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache for every tpulc entry
    point (CLI, library, smoke test).  Large-block programs take long
    to compile; the cache makes that a once-per-machine cost.

    A directory already configured (JAX_COMPILATION_CACHE_DIR, which
    JAX reads itself, or jax.config) is used as given.  Otherwise the
    cache is `<checkout>/.jax_cache`, if the checkout is writable; CPU
    processes use a per-machine subdirectory of it, because CPU
    executables are compiled for the host's exact CPU features."""
    import os

    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.access(repo, os.W_OK):
        return
    path = os.path.join(repo, ".jax_cache")
    platforms = str(jax.config.jax_platforms
                    or os.environ.get("JAX_PLATFORMS", ""))
    if platforms == "cpu":
        from tpulc.utils.cachedir import machine_cache_dir

        path = machine_cache_dir(path)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from tpulc.pipeline.registry import available_codecs  # noqa: F401
