"""The four CUDPP primitives outside the compress path.

SURVEY.md §2.4 scoped compression to sort/scan/histogram, but the
reference library also ships `cudppRand` (MD5 counter-mode PRNG,
`rand_app.cu` + `rand_kernel.cuh`), `cudppSparseMatrixVectorMultiply`
(`spmvmult_app.cu`), `cudppTridiagonal` (CR-PCR solver,
`tridiagonal_app.cu`) and the cuckoo hash tables (`src/cudpp_hash/`).
These are their JAX equivalents:

- `md5_rand`: counter-mode MD5, fully vectorized over blocks — one
  64-round unrolled pass on [n, 16]-word messages; bit-exact vs
  hashlib.md5 (pinned by test), so the stream is reproducible across
  machines exactly like cudpp's deterministic hashes.
- `spmv`: CSR y = A @ x as one gather + one segment-sum.
- `tridiagonal_solve`: batched cyclic reduction — log2(n) vectorized
  elimination rounds, the `crpcrKernel` recurrence without the shared-
  memory system-per-block layout.
- `CuckooTable`: two-choice cuckoo hashing (the cudpp_hash basic
  table): device-side eviction rounds via scatter/readback; lookups
  are two gathers + compares.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# ---- MD5 (counter mode) ---------------------------------------------

_MD5_K = np.floor(np.abs(np.sin(np.arange(1, 65))) * (1 << 32)).astype(
    np.uint32)
_MD5_S = np.array(
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4
    + [6, 10, 15, 21] * 4, np.int32)
_MD5_INIT = np.array(
    [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476], np.uint32)


def _rotl(x, s):
    return (x << jnp.uint32(s)) | (x >> jnp.uint32(32 - s))


@jax.jit
def md5_blocks(m: jax.Array) -> jax.Array:
    """MD5 compression of single-block messages.

    m: uint32[n, 16] little-endian message words (caller pads).
    Returns uint32[n, 4] digests (a, b, c, d little-endian words).
    """
    a = jnp.full(m.shape[:1], _MD5_INIT[0], jnp.uint32)
    b = jnp.full(m.shape[:1], _MD5_INIT[1], jnp.uint32)
    c = jnp.full(m.shape[:1], _MD5_INIT[2], jnp.uint32)
    d = jnp.full(m.shape[:1], _MD5_INIT[3], jnp.uint32)
    for i in range(64):
        if i < 16:
            f = (b & c) | (~b & d)
            g = i
        elif i < 32:
            f = (d & b) | (~d & c)
            g = (5 * i + 1) % 16
        elif i < 48:
            f = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            f = c ^ (b | ~d)
            g = (7 * i) % 16
        tmp = d
        d = c
        c = b
        rot = a + f + jnp.uint32(int(_MD5_K[i])) + m[:, g]
        b = b + _rotl(rot, int(_MD5_S[i]))
        a = tmp
    return jnp.stack([a + jnp.uint32(int(_MD5_INIT[0])),
                      b + jnp.uint32(int(_MD5_INIT[1])),
                      c + jnp.uint32(int(_MD5_INIT[2])),
                      d + jnp.uint32(int(_MD5_INIT[3]))], axis=1)


@partial(jax.jit, static_argnames=("n",))
def md5_rand(n: int, seed: jax.Array) -> jax.Array:
    """cudppRand (CUDPP_RAND_MD5 role): n uint32s of deterministic
    randomness from MD5 over (seed, counter) 8-byte messages with
    standard MD5 padding — each counter block yields 4 words."""
    nblk = -(-n // 4)
    idx = jnp.arange(nblk, dtype=jnp.uint32)
    m = jnp.zeros((nblk, 16), jnp.uint32)
    m = m.at[:, 0].set(jnp.uint32(seed))
    m = m.at[:, 1].set(idx)
    m = m.at[:, 2].set(jnp.uint32(0x80))    # padding bit after 8 bytes
    m = m.at[:, 14].set(jnp.uint32(64))     # message length in bits
    return md5_blocks(m).reshape(-1)[:n]


# ---- sparse matrix-vector multiply (CSR) ----------------------------

def spmv(values: jax.Array, cols: jax.Array, row_ptr: jax.Array,
         x: jax.Array) -> jax.Array:
    """cudppSparseMatrixVectorMultiply: CSR y = A @ x.

    values/cols: nnz entries; row_ptr: int32[nrows+1].
    One x-gather + one segment-sum (the reference's scan-based spmv,
    `spmvmult_app.cu`)."""
    nrows = row_ptr.shape[0] - 1
    prod = values * x[cols]
    row_of = jnp.searchsorted(
        row_ptr[1:], jnp.arange(cols.shape[0], dtype=jnp.int32),
        side="right").astype(jnp.int32)
    return jax.ops.segment_sum(prod, row_of, num_segments=nrows)


# ---- tridiagonal solver (batched cyclic reduction) ------------------

@jax.jit
def tridiagonal_solve(a: jax.Array, b: jax.Array, c: jax.Array,
                      d: jax.Array) -> jax.Array:
    """cudppTridiagonal (crpcr role): solve tridiagonal systems.

    a (sub), b (diag), c (super), d (rhs): float[B, n], n a power of
    two; a[:,0] and c[:,n-1] are ignored.  Parallel cyclic reduction:
    log2(n) vectorized rounds, no per-system serial loop."""
    B, n = b.shape
    a = a.at[:, 0].set(0)
    c = c.at[:, -1].set(0)
    stride = 1
    while stride < n:
        def shl(x):
            return jnp.pad(x, ((0, 0), (0, stride)))[:, stride:]

        def shr(x):
            return jnp.pad(x, ((0, 0), (stride, 0)))[:, :n]

        alpha = -a / jnp.where(shr(b) == 0, 1, shr(b))
        alpha = jnp.where(jnp.arange(n) >= stride, alpha, 0)
        beta = -c / jnp.where(shl(b) == 0, 1, shl(b))
        beta = jnp.where(jnp.arange(n) < n - stride, beta, 0)
        a_n = alpha * shr(a)
        b_n = b + alpha * shr(c) + beta * shl(a)
        c_n = beta * shl(c)
        d_n = d + alpha * shr(d) + beta * shl(d)
        a, b, c, d = a_n, b_n, c_n, d_n
        stride *= 2
    return d / b


# ---- cuckoo hash table (cudpp_hash basic table) ---------------------

_EMPTY = jnp.uint32(0xFFFFFFFF)


def _h(keys, seed, size):
    x = keys.astype(jnp.uint32) ^ jnp.uint32(seed)
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x45D9F3B)
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x45D9F3B)
    x = x ^ (x >> jnp.uint32(16))
    return (x % jnp.uint32(size)).astype(jnp.int32)


class CuckooTable:
    """Multiple-choice hash table with stash (the cudpp_hash
    `CUDPP_BASIC_HASH_TABLE` role — cudpp's tables are 4-way cuckoo
    with a stash, `src/cudpp_hash/hash_table.cu`).

    Build: parallel EVICTION cuckoo livelocks under
    simultaneous scatters (measured: a fighting core of keys thrashes
    forever), so the build is 4-choice FIRST-WRITER-WINS insertion —
    placed keys are never disturbed, each round monotonically fills
    empty slots — plus a small sorted stash for stragglers (cudpp's
    own stash design).  Lookups: 4 gathers + a searchsorted stash
    probe, all device-side.  Keys are uint32 != 0xFFFFFFFF."""

    SEEDS = (0x9E37, 0x85EB, 0xC2B2AE35, 0x27D4EB2F)

    def __init__(self, keys: np.ndarray, vals: np.ndarray,
                 space: float = 1.6, max_rounds: int = 24):
        n = len(keys)
        size = max(8, int(n * space))
        tk = jnp.full((size,), _EMPTY, jnp.uint32)
        tv = jnp.zeros((size,), jnp.uint32)
        k = jnp.asarray(keys, dtype=jnp.uint32)
        v = jnp.asarray(vals, dtype=jnp.uint32)
        hs = [_h(k, s, size) for s in self.SEEDS]
        choice = jnp.zeros((n,), jnp.int32)
        pending = jnp.ones((n,), bool)
        for _ in range(max_rounds):
            slot = hs[0]
            for ci in range(1, 4):
                slot = jnp.where(choice == ci, hs[ci], slot)
            free = tk[slot] == _EMPTY
            tgt = jnp.where(pending & free, slot, size)
            tk = tk.at[tgt].set(k, mode="drop")
            tv = tv.at[tgt].set(v, mode="drop")
            placed_now = pending & (tk[slot] == k) & (tv[slot] == v)
            pending = pending & ~placed_now
            # losers (slot occupied, or lost the write race) advance
            choice = jnp.where(pending, (choice + 1) % 4, choice)
            if not bool(pending.any()):
                break
        self.tk, self.tv = tk, tv
        self.size = size
        idx = np.flatnonzero(np.asarray(pending))
        sk = np.asarray(keys, np.uint32)[idx]
        sv = np.asarray(vals, np.uint32)[idx]
        order = np.argsort(sk)
        self.stash_k = jnp.asarray(np.append(sk[order],
                                             np.uint32(0xFFFFFFFF)))
        self.stash_v = jnp.asarray(np.append(sv[order], np.uint32(0)))

    def lookup(self, keys) -> tuple[jax.Array, jax.Array]:
        """-> (values uint32, found bool)."""
        k = jnp.asarray(keys, dtype=jnp.uint32)
        val = jnp.zeros(k.shape, jnp.uint32)
        found = jnp.zeros(k.shape, bool)
        for s in self.SEEDS:
            sl = _h(k, s, self.size)
            hit = (self.tk[sl] == k) & ~found
            val = jnp.where(hit, self.tv[sl], val)
            found = found | hit
        pos = jnp.searchsorted(self.stash_k[:-1], k).astype(jnp.int32)
        shit = (self.stash_k[pos] == k) & ~found
        val = jnp.where(shit, self.stash_v[pos], val)
        return val, found | shit
