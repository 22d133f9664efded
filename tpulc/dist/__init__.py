"""Multi-chip / multi-host distribution layer.

The reference has no multi-GPU code (SURVEY.md §2.7); its block-level
parallelism (OpenMP loops, pthread rings, atomic-counter schedulers) is
replaced by JAX's own: a 1D `jax.sharding.Mesh` over the `'blocks'`
axis, `shard_map`-ed per-block codecs, `psum` for shared-dictionary
histograms, and `all_gather` of per-block compressed sizes to build the
container offset table.
"""

from tpulc.dist.mesh import make_mesh  # noqa: F401
from tpulc.dist.sharded import (  # noqa: F401
    global_histogram,
    sharded_huffman_encode,
    sharded_huffman_roundtrip_step,
)
