"""Group-rank adaptive binary rANS coder — the bsc `-e2` coder (v3).

QLFC-class decomposition (libbsc `qlfc.cpp:448-752`): the MTF rank
stream is coded as (rank, run-length) GROUPS — rank==1 test, exponent
unary, tree-path-context mantissa; run==1 test, exponent, tree-path
mantissa — instead of the RLE2 digit stream `rans_adaptive.py` codes.
Offline pricing (an information-content simulation on the bench
corpus, since removed): 165.5 KB vs
the RLE2-event coder's 167.9 KB, at 16% fewer lockstep steps
(maxbits 5799 vs 6897 per 1024-symbol lane).

Mixing stands in for libbsc's char/state/static mixer triple
(per-char models need the MTF recency list, which lane-parallel decode
cannot reproduce): integer mix of the fine-context adaptive counter,
a family-level coarse counter, and the wired block-static init:

    pe = (19 * fine + 7 * coarse + 6 * init) >> 5

Lanes cut the MTF stream every GCHUNK symbols; groups truncate at lane
boundaries and a lane-initial continuation group (leading zero-run)
codes one L0 bit instead of a rank.  Encode is ONE device program:
vectorized binarization (static 35 scatter rounds, no FSM) -> block
stats + integer init quantization from the event grid -> forward model
walk -> reverse rANS; a tiny lane-bits pre-pass sizes the grid.
Decode: per-lane FSM in lockstep, one bit per step — the SAME model
arithmetic, so probabilities match bit-for-bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

GCHUNK = 1024
PROB_BITS = 12
SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
RATE_F = 4             # fine counter shift
RATE_C = 5             # coarse counter shift
MAX_EK = 10            # run exponent cap (k <= GCHUNK = 2^10)

B_L0 = 0
B_RT = 1
B_RE = B_RT + 256
B_RM = B_RE + 28
B_UT = B_RM + 7 * 64
B_UE = B_UT + 128
B_UM = B_UE + 40
NM = B_UM + MAX_EK * 32            # 1221
NFAM = 7
_FAM_BASES = (B_L0, B_RT, B_RE, B_RM, B_UT, B_UE, B_UM, NM)

# events per group bound: L0 + RT + 6 RE + 7 RM + UT + 9 UE + 10 UM
MAX_GROUP_BITS = 35


def fam_of_model() -> np.ndarray:
    f = np.zeros(NM, np.int32)
    for i in range(NFAM):
        f[_FAM_BASES[i]: _FAM_BASES[i + 1]] = i
    return f


def _bitlen(v):
    return 32 - jax.lax.clz(jnp.maximum(v, 1).astype(jnp.uint32)).astype(
        jnp.int32)


def _ctx_regs(prev_r, prev2_r, prev_k, prev2_k, prev_e):
    q1 = jnp.minimum(prev_r, 3)
    q2_ = jnp.minimum(prev2_r, 3)
    cR4 = q1 * 4 + q2_
    cRun = (prev_k < 3).astype(jnp.int32) * 2 + (
        prev2_k < 3).astype(jnp.int32)
    hE = jnp.minimum(prev_e, 3)
    cR4c = jnp.minimum(q1 * 2 + (prev2_r > 0).astype(jnp.int32), 3)
    cR0 = ((prev_r == 1).astype(jnp.int32) * 4
           + (prev2_r == 1).astype(jnp.int32) * 2
           + (prev_r > 4).astype(jnp.int32))
    return cR4, cRun, hE, cR4c, cR0


def _rq_of(r):
    return jnp.minimum(jnp.maximum(r - 1, 0), 2) + (r == 0).astype(
        jnp.int32)


def _binarize(ranks: jax.Array, m: jax.Array, W: int,
              chunk: int = GCHUNK, bs: int | None = None):
    """ranks int32[cap] -> packed event grid gmb int32[L, W]
    (rec = (model+1)*2 + bit; 0 = empty) + lane_bits int32[L].

    Group starts are COMPACTED first (one 2-operand sort), so the 35
    event scatter rounds run over the ~nstarts live groups instead of
    all cap positions (scatter cost is per SOURCE element), and
    the prev/prev2 context gathers become shifts of the compact array.
    `bs` is the static start-count bucket (host-derived from the
    `grc_lane_bits` pre-pass; None = cap, always safe)."""
    cap = ranks.shape[0]
    L = cap // chunk
    if bs is None:
        bs = cap
    pos = jnp.arange(cap, dtype=jnp.int32)
    valid = pos < m
    rk_full = jnp.where(valid, ranks.astype(jnp.int32), 0)
    is_start = ((rk_full != 0) | (pos % chunk == 0)) & valid
    nstarts = jnp.sum(is_start.astype(jnp.int32))

    # stable compact: starts (by position) first, then the rest
    key = jnp.where(is_start, pos, cap + pos)
    _, spos, rk = jax.lax.sort((key, pos, rk_full), num_keys=1)
    spos, rk = spos[:bs], rk[:bs]
    sval = (jnp.arange(bs, dtype=jnp.int32) < nstarts)
    lane = spos // chunk
    ilp = spos % chunk
    lane_end = (lane + 1) * chunk

    nxt = jnp.concatenate([spos[1:], jnp.full((1,), cap + 1, jnp.int32)])
    nxt_v = jnp.concatenate([sval[1:], jnp.zeros((1,), bool)])
    nxt = jnp.where(nxt_v, nxt, cap + 1)
    k = jnp.clip(jnp.minimum(jnp.minimum(nxt, lane_end), m) - spos,
                 1, chunk)

    def shift1(x, fill):
        return jnp.concatenate(
            [jnp.full((1,), fill, x.dtype), x[:-1]])

    same1 = shift1(lane, -1) == lane
    same2 = jnp.concatenate(
        [jnp.full((2,), -1, jnp.int32), lane[:-2]]) == lane
    prev_r = jnp.where(same1, shift1(rk, 0), 0)
    prev_k = jnp.where(same1, shift1(k, 1), 1)
    prev2_r = jnp.where(
        same2, jnp.concatenate([jnp.zeros((2,), jnp.int32), rk[:-2]]), 0)
    prev2_k = jnp.where(
        same2, jnp.concatenate([jnp.ones((2,), jnp.int32), k[:-2]]), 1)
    prev_e = jnp.where(prev_r > 0, _bitlen(prev_r) - 1, 0)
    cR4, cRun, hE, cR4c, cR0 = _ctx_regs(prev_r, prev2_r, prev_k,
                                         prev2_k, prev_e)
    rq = _rq_of(rk)

    r = rk
    E = jnp.where(r > 1, _bitlen(r) - 1, 0)
    nRE = jnp.where(r > 1, (E - 1) + (E < 7).astype(jnp.int32), 0)
    Ek = jnp.where(k > 1, _bitlen(k) - 1, 0)
    nUE = jnp.where(k > 1, (Ek - 1) + (Ek < MAX_EK).astype(jnp.int32), 0)
    has_l0 = (ilp == 0) & sval
    has_rank = sval & (r > 0)
    is_start = sval
    ev = (has_l0.astype(jnp.int32)
          + has_rank.astype(jnp.int32) * (1 + nRE + E)
          + is_start.astype(jnp.int32) * (1 + nUE + Ek))
    ev = jnp.where(is_start, ev, 0)
    # per-lane exclusive offsets: segmented cumsum over the compact
    # (position-ordered) starts, segments reset at lane changes
    newlane = ~same1

    def segsum(a, b):
        v1, f1 = a
        v2, f2 = b
        return jnp.where(f2, v2, v1 + v2), f1 | f2

    incl, _ = jax.lax.associative_scan(segsum, (ev, newlane))
    off = incl - ev
    lane_bits = jnp.zeros((L,), jnp.int32).at[lane].add(
        ev, mode="drop")

    gmb = jnp.zeros((L, W), jnp.int32)

    def scat(gmb, mask, tgt, model, bit):
        rec = jnp.where(mask, (model + 1) * 2 + bit, 0)
        t2 = jnp.where(mask, tgt, W)
        return gmb.at[lane, t2].set(rec, mode="drop")

    d = jnp.zeros(bs, jnp.int32)
    # L0
    gmb = scat(gmb, has_l0, off, jnp.zeros(bs, jnp.int32),
               (r == 0).astype(jnp.int32))
    d = d + has_l0.astype(jnp.int32)
    # RT
    gmb = scat(gmb, has_rank, off + d,
               B_RT + cR4 * 16 + cRun * 4 + hE,
               (r == 1).astype(jnp.int32))
    d = d + has_rank.astype(jnp.int32)
    # RE levels 1..6
    for lvl in range(1, 7):
        mk = has_rank & (nRE >= lvl)
        gmb = scat(gmb, mk, off + d, B_RE + (lvl - 1) * 4 + cR4c,
                   (E > lvl).astype(jnp.int32))
        d = d + mk.astype(jnp.int32)
    # RM bits t = 0..E-1 (MSB first); path register = r >> (E - t)
    for t in range(7):
        mk = has_rank & (E > t)
        path = jnp.minimum(r >> jnp.maximum(E - t, 0), 63)
        bit = (r >> jnp.maximum(E - 1 - t, 0)) & 1
        ee = jnp.maximum(E, 1)
        gmb = scat(gmb, mk, off + d, B_RM + (ee - 1) * 64 + path, bit)
        d = d + mk.astype(jnp.int32)
    # UT
    gmb = scat(gmb, is_start, off + d,
               B_UT + rq * 32 + cRun * 8 + cR0,
               (k == 1).astype(jnp.int32))
    d = d + is_start.astype(jnp.int32)
    # UE levels 1..MAX_EK-1
    for lvl in range(1, MAX_EK):
        mk = is_start & (nUE >= lvl)
        gmb = scat(gmb, mk, off + d, B_UE + (lvl - 1) * 4 + rq,
                   (Ek > lvl).astype(jnp.int32))
        d = d + mk.astype(jnp.int32)
    # UM bits
    for t in range(MAX_EK):
        mk = is_start & (Ek > t)
        path = jnp.minimum(k >> jnp.maximum(Ek - t, 0), 31)
        bit = (k >> jnp.maximum(Ek - 1 - t, 0)) & 1
        ee = jnp.maximum(Ek, 1)
        gmb = scat(gmb, mk, off + d, B_UM + (ee - 1) * 32 + path, bit)
        d = d + mk.astype(jnp.int32)
    return gmb, lane_bits


@partial(jax.jit, static_argnames=("chunk", "W"))
def grc_stats(ranks: jax.Array, m: jax.Array, W: int,
              chunk: int = GCHUNK):
    """-> (ones int32[NM], tot int32[NM], cones[NFAM], ctot[NFAM],
    lane_bits int32[L])."""
    gmb, lane_bits = _binarize(ranks, m, W, chunk)
    flat = gmb.reshape(-1)
    mdl = jnp.maximum(flat // 2 - 1, 0)
    used = flat > 0
    bit = (flat & 1).astype(jnp.int32)
    tot = jnp.zeros((NM,), jnp.int32).at[
        jnp.where(used, mdl, 0)].add(used.astype(jnp.int32))
    ones = jnp.zeros((NM,), jnp.int32).at[
        jnp.where(used, mdl, 0)].add(bit * used.astype(jnp.int32))
    fam = jnp.asarray(fam_of_model())
    cf = fam[mdl]
    ctot = jnp.zeros((NFAM,), jnp.int32).at[
        jnp.where(used, cf, 0)].add(used.astype(jnp.int32))
    cones = jnp.zeros((NFAM,), jnp.int32).at[
        jnp.where(used, cf, 0)].add(bit * used.astype(jnp.int32))
    return ones, tot, cones, ctot, lane_bits


def quantize_inits(ones: np.ndarray, tot: np.ndarray) -> np.ndarray:
    p = np.where(tot > 0, ones / np.maximum(tot, 1), 0.5)
    return np.clip((p * SCALE).astype(np.int64), 8, SCALE - 8).astype(
        np.uint16)


def pack_inits(inits: np.ndarray, tot: np.ndarray) -> bytes:
    """Sparse init table: bitmap of used models + u16 per used entry
    (typical blocks touch a fraction of the 1221 models; unused ones
    decode to the 2048 midpoint on both sides)."""
    used = tot > 0
    bits = np.zeros(-(-NM // 8) * 8, np.uint8)
    bits[:NM] = used
    return (np.packbits(bits).tobytes()
            + inits[used].astype("<u2").tobytes())


def unpack_inits(buf: bytes, off: int):
    nb = -(-NM // 8)
    used = np.unpackbits(
        np.frombuffer(buf[off: off + nb], np.uint8))[:NM].astype(bool)
    off += nb
    nu = int(used.sum())
    vals = np.frombuffer(buf[off: off + 2 * nu], "<u2")
    off += 2 * nu
    inits = np.full(NM, SCALE // 2, np.uint16)
    inits[used] = vals
    return inits, off


def _mix(pf, pc, pi):
    pe = (19 * pf + 7 * pc + 6 * pi) >> 5
    return jnp.clip(pe, 8, SCALE - 8)


def _adapt(p, bit, upd, rate):
    step = ((bit << PROB_BITS) - p) >> rate
    return jnp.where(upd, jnp.clip(p + step, 8, SCALE - 8), p)


@partial(jax.jit, static_argnames=("chunk",))
def grc_lane_bits(ranks: jax.Array, m: jax.Array, chunk: int = GCHUNK):
    """(event count per lane int32[L], group-start count int32[]) —
    the host sizes the encode grid W and the start bucket `bs` from
    this pre-pass (elementwise + cumsum; no grid)."""
    cap = ranks.shape[0]
    L = cap // chunk
    pos = jnp.arange(cap, dtype=jnp.int32)
    valid = pos < m
    rk = jnp.where(valid, ranks.astype(jnp.int32), 0)
    ilp = pos % chunk
    is_start = ((rk != 0) | (ilp == 0)) & valid
    lane_end = (pos // chunk + 1) * chunk
    nxt_start = jax.lax.associative_scan(
        jnp.minimum, jnp.where(is_start, pos, cap + 1), reverse=True)
    nxt_after = jnp.concatenate(
        [nxt_start[1:], jnp.full((1,), cap + 1, jnp.int32)])
    k = jnp.clip(jnp.minimum(jnp.minimum(nxt_after, lane_end),
                             m) - pos, 1, chunk)
    r = rk
    E = jnp.where(r > 1, _bitlen(r) - 1, 0)
    nRE = jnp.where(r > 1, (E - 1) + (E < 7).astype(jnp.int32), 0)
    Ek = jnp.where(k > 1, _bitlen(k) - 1, 0)
    nUE = jnp.where(k > 1, (Ek - 1) + (Ek < MAX_EK).astype(jnp.int32), 0)
    has_l0 = (ilp == 0) & is_start
    has_rank = is_start & (r > 0)
    ev = (has_l0.astype(jnp.int32)
          + has_rank.astype(jnp.int32) * (1 + nRE + E)
          + is_start.astype(jnp.int32) * (1 + nUE + Ek))
    ev = jnp.where(is_start, ev, 0)
    return (ev.reshape(L, chunk).sum(axis=1),
            jnp.sum(is_start.astype(jnp.int32)))


def _stats_quant(gmb: jax.Array):
    """Block stats + integer init quantization from the event grid ->
    (init_i int32[NM], cinit_i int32[NFAM], tot int32[NM]).

    Two scatter-adds, not four: the families partition the model id
    space, so the coarse counts are segment-sums of the fine ones
    (scatter-adds were the dominant -e2 encode op)."""
    # ONE histogram of the packed record value (rec = (m+1)*2+bit):
    # tot/ones fall out as slice sums, so the four scatter-adds the r4
    # trace measured at ~73 ms each collapse into a single one — and
    # the grid is SUBSAMPLED 4x: the counts only seed the quantized
    # wired inits (6/32 of the mix), where sampling noise over millions
    # of events is far below the 1/4096 quantization grain.  Encoder
    # and decoder both use the wired values, so the stream stays
    # self-consistent; `grc_stats` remains the exact-count API.
    flat = gmb.reshape(-1)[::4]
    hist = jnp.zeros((2 * NM + 2,), jnp.int32).at[
        jnp.minimum(flat, 2 * NM + 1)].add(1)
    ones = hist[3::2]
    tot = hist[2::2] + ones
    bases = jnp.asarray(_FAM_BASES)
    seg = jnp.cumsum(tot)
    segc = jnp.concatenate([jnp.zeros((1,), jnp.int32), seg])[bases]
    ctot = segc[1:] - segc[:-1]
    sego = jnp.cumsum(ones)
    segoc = jnp.concatenate([jnp.zeros((1,), jnp.int32), sego])[bases]
    cones = segoc[1:] - segoc[:-1]

    def _quant(o, t):
        # o * SCALE overflows int32 once a model sees >2^19 events
        # (routine at 25 MB blocks); divide in f32 instead — relative
        # error ~2^-24 is far below the 1/SCALE quantization grain.
        r = o.astype(jnp.float32) / jnp.maximum(t, 1).astype(jnp.float32)
        p = jnp.where(t > 0, (r * SCALE).astype(jnp.int32), SCALE // 2)
        return jnp.clip(p, 8, SCALE - 8)

    init_i = _quant(ones, tot)                  # [NM]
    cinit_i = _quant(cones, ctot)               # [NFAM]
    return init_i, cinit_i, tot


def _walk_probs(gmb: jax.Array, init_i: jax.Array, cinit_i: jax.Array,
                lane_bits: jax.Array):
    """XLA forward model walk -> probs uint16-valued int32[L, W]."""
    L, W = gmb.shape
    fam = jnp.asarray(fam_of_model())
    pstate0 = jnp.broadcast_to(init_i[None, :], (L, NM)).astype(jnp.int32)
    cstate0 = jnp.broadcast_to(cinit_i[None, :], (L, NFAM)).astype(
        jnp.int32)
    probs0 = jnp.zeros((W, L), jnp.uint16)
    nsteps = jnp.max(lane_bits)
    mcol = jnp.arange(NM, dtype=jnp.int32)[None, :]
    ccol = jnp.arange(NFAM, dtype=jnp.int32)[None, :]

    def mbody(t, st):
        pstate, cstate, probs = st
        e = gmb[:, t]
        mdl = jnp.maximum(e // 2 - 1, 0)
        upd = e > 0
        bit = e & 1
        hit = mcol == mdl[:, None]
        chit = ccol == fam[mdl][:, None]
        pf = jnp.sum(jnp.where(hit, pstate, 0), axis=1)
        pc = jnp.sum(jnp.where(chit, cstate, 0), axis=1)
        pe = _mix(pf, pc, init_i[mdl])
        probs = jax.lax.dynamic_update_slice(
            probs, pe.astype(jnp.uint16)[None, :], (t, 0))
        nf = _adapt(pf, bit, upd, RATE_F)
        nc = _adapt(pc, bit, upd, RATE_C)
        pstate = jnp.where(hit & upd[:, None], nf[:, None], pstate)
        cstate = jnp.where(chit & upd[:, None], nc[:, None], cstate)
        return pstate, cstate, probs

    def m4(s, st):
        for q in range(4):
            st = mbody(s * 4 + q, st)
        return st

    _, _, probs = jax.lax.fori_loop(0, (nsteps + 3) // 4, m4,
                                    (pstate0, cstate0, probs0))
    return probs.T


def _reverse_rans(gmb: jax.Array, probs: jax.Array,
                  nsteps: jax.Array):
    """Reverse-order rANS emission from the prob grid ->
    (words uint16[L, W+2], counts int32[L], states uint32[L])."""
    L, W = gmb.shape
    x0 = jnp.full((L,), RANS_L, jnp.uint32)
    emit0 = jnp.zeros((W, L), jnp.uint16)
    emask0 = jnp.zeros((W, L), bool)

    def ebody(i, st):
        x, emit, emask = st
        t = nsteps - 1 - i
        e = gmb[:, jnp.maximum(t, 0)]
        vq = (e > 0) & (t >= 0)
        b = (e & 1).astype(jnp.uint32)
        p1 = probs[:, jnp.maximum(t, 0)].astype(jnp.uint32)
        f = jnp.where(b == 1, p1, SCALE - p1)
        c = jnp.where(b == 1, SCALE - p1, 0).astype(jnp.uint32)
        x_max = f << jnp.uint32(32 - PROB_BITS)
        do_emit = vq & (x >= x_max)
        emit = jax.lax.dynamic_update_slice(
            emit, (x & 0xFFFF).astype(jnp.uint16)[None, :], (i, 0))
        emask = jax.lax.dynamic_update_slice(
            emask, do_emit[None, :], (i, 0))
        x = jnp.where(do_emit, x >> jnp.uint32(16), x)
        fx = jnp.maximum(f, 1)
        x_new = ((x // fx) << jnp.uint32(PROB_BITS)) + (x % fx) + c
        x = jnp.where(vq, x_new, x)
        return x, emit, emask

    def e4(s, st):
        for q in range(4):
            st = ebody(s * 4 + q, st)
        return st

    x, emit, emask = jax.lax.fori_loop(0, (nsteps + 3) // 4, e4,
                                       (x0, emit0, emask0))
    emit_t = emit.T
    emask_t = emask.T
    counts = jnp.sum(emask_t.astype(jnp.int32), axis=1)
    pos_in_lane = jnp.cumsum(emask_t.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(emask_t, counts[:, None] - 1 - pos_in_lane, W + 2)
    words = jnp.zeros((L, W + 2), jnp.uint16)
    words = words.at[
        jnp.arange(L, dtype=jnp.int32)[:, None], tgt
    ].set(emit_t, mode="drop")
    return words, counts, x


@partial(jax.jit, static_argnames=("chunk", "W", "bs"))
def grc_encode(ranks: jax.Array, m: jax.Array, W: int,
               chunk: int = GCHUNK, bs: int | None = None):
    """ONE device program: binarize -> block stats -> init quantization
    -> forward model walk -> reverse rANS.

    -> (words uint16[L, W+2], counts int32[L], states uint32[L],
        inits uint16[NM], cinits uint16[NFAM], tot int32[NM])."""
    gmb, lane_bits = _binarize(ranks, m, W, chunk, bs)
    init_i, cinit_i, tot = _stats_quant(gmb)
    nsteps = jnp.max(lane_bits)
    probs = _walk_probs(gmb, init_i, cinit_i, lane_bits)
    words, counts, x = _reverse_rans(gmb, probs, nsteps)
    return (words, counts, x, init_i.astype(jnp.uint16),
            cinit_i.astype(jnp.uint16), tot)


@partial(jax.jit, static_argnames=("chunk", "cap"))
def grc_decode(words: jax.Array, counts: jax.Array, states: jax.Array,
               m: jax.Array, inits: jax.Array, cinits: jax.Array,
               nsteps: jax.Array, cap: int, chunk: int = GCHUNK):
    """Forward FSM decode -> ranks int32[cap]."""
    del counts
    L = cap // chunk
    rows = jnp.arange(L, dtype=jnp.int32)
    nsym_lane = jnp.clip(m - rows * chunk, 0, chunk)
    fam = jnp.asarray(fam_of_model())
    init_i = inits.astype(jnp.int32)
    cinit_i = cinits.astype(jnp.int32)
    pstate = jnp.broadcast_to(init_i[None, :], (L, NM)).astype(jnp.int32)
    cstate = jnp.broadcast_to(cinit_i[None, :], (L, NFAM)).astype(
        jnp.int32)

    x0 = states.astype(jnp.uint32)
    rpos0 = jnp.zeros((L,), jnp.int32)
    out0 = jnp.zeros((L, chunk), jnp.int32)
    z = jnp.zeros((L,), jnp.int32)
    # FSM registers
    st0 = dict(
        x=x0, rpos=rpos0, out=out0, opos=z,
        phase=z,              # 0 L0, 1 RT, 2 RE, 3 RM, 4 UT, 5 UE, 6 UM
        lvl=z, val=z, mleft=z, ek=z, kval=z, kleft=z, r=z,
        prev_r=z, prev2_r=z, prev_k=z + 1, prev2_k=z + 1, prev_e=z,
    )
    mcol = jnp.arange(NM, dtype=jnp.int32)[None, :]
    ccol = jnp.arange(NFAM, dtype=jnp.int32)[None, :]
    ocol = jnp.arange(chunk, dtype=jnp.int32)[None, :]
    Wp2 = words.shape[1]

    def body2(t, carry):
        (x, rpos, out, opos, phase, lvl, val, mleft, ek, kval, kleft,
         r, prev_r, prev2_r, prev_k, prev2_k, prev_e,
         pstate, cstate) = carry
        active = opos < nsym_lane
        cR4, cRun, hE, cR4c, cR0 = _ctx_regs(
            prev_r, prev2_r, prev_k, prev2_k, prev_e)
        rq = _rq_of(r)
        mdl = jnp.where(
            phase == 0, B_L0,
            jnp.where(
                phase == 1, B_RT + cR4 * 16 + cRun * 4 + hE,
                jnp.where(
                    phase == 2,
                    B_RE + (jnp.clip(lvl, 1, 6) - 1) * 4 + cR4c,
                    jnp.where(
                        phase == 3,
                        B_RM + (jnp.clip(ek, 1, 7) - 1) * 64
                        + jnp.minimum(val, 63),
                        jnp.where(
                            phase == 4,
                            B_UT + rq * 32 + cRun * 8 + cR0,
                            jnp.where(
                                phase == 5,
                                B_UE + (jnp.clip(lvl, 1, MAX_EK - 1)
                                        - 1) * 4 + rq,
                                B_UM + (jnp.clip(ek, 1, MAX_EK)
                                        - 1) * 32
                                + jnp.minimum(kval, 31),
                            ))))))
        mdl = jnp.clip(mdl, 0, NM - 1)
        hit = mcol == mdl[:, None]
        chit = ccol == fam[mdl][:, None]
        pf = jnp.sum(jnp.where(hit, pstate, 0), axis=1)
        pc = jnp.sum(jnp.where(chit, cstate, 0), axis=1)
        pe = _mix(pf, pc, init_i[mdl]).astype(jnp.uint32)
        f0 = jnp.uint32(SCALE) - pe
        slot = x & jnp.uint32(SCALE - 1)
        bit = (slot >= f0).astype(jnp.int32)
        f = jnp.where(bit == 1, pe, f0)
        c = jnp.where(bit == 1, f0, 0)
        x_new = f * (x >> jnp.uint32(PROB_BITS)) + slot - c
        need = active & (x_new < jnp.uint32(RANS_L))
        w = words[rows, jnp.minimum(rpos, Wp2 - 1)].astype(jnp.uint32)
        x_new2 = jnp.where(need, (x_new << jnp.uint32(16)) | w, x_new)
        rpos = rpos + need.astype(jnp.int32)
        x = jnp.where(active, x_new2, x)
        nf = _adapt(pf, bit, active, RATE_F)
        nc = _adapt(pc, bit, active, RATE_C)
        pstate = jnp.where(hit & active[:, None], nf[:, None], pstate)
        cstate = jnp.where(chit & active[:, None], nc[:, None], cstate)

        b1 = bit == 1
        is0, is1, is2 = phase == 0, phase == 1, phase == 2
        is3, is4, is5, is6 = phase == 3, phase == 4, phase == 5, \
            phase == 6
        # --- rank side ---
        r_n = jnp.where(is0 & b1, 0, jnp.where(is1 & b1, 1, r))
        to_ut = (is0 & b1) | (is1 & b1)
        to_rt = is0 & ~b1
        to_re = is1 & ~b1
        lvl_n = jnp.where(to_re, 1, lvl)
        # RE transitions
        re_cont = is2 & b1
        lvl_n = jnp.where(re_cont, lvl + 1, lvl_n)
        re_to_rm_hi = re_cont & (lvl_n == 7)        # E = 7 implied
        re_stop = is2 & ~b1                         # E = lvl
        enter_rm = re_to_rm_hi | re_stop
        ek_rank = jnp.where(re_to_rm_hi, 7, lvl)    # reuse ek as E in RM
        ek_n = jnp.where(enter_rm, ek_rank, ek)
        val_n = jnp.where(enter_rm, 1, val)
        mleft_n = jnp.where(enter_rm, ek_rank, mleft)
        # RM transitions
        val_n = jnp.where(is3, val * 2 + bit, val_n)
        mleft_n = jnp.where(is3, mleft - 1, mleft_n)
        rm_done = is3 & (mleft_n == 0)
        r_n = jnp.where(rm_done, val_n, r_n)
        to_ut = to_ut | rm_done
        # --- run side ---
        ut_one = is4 & b1
        to_ue = is4 & ~b1
        lvl_n = jnp.where(to_ue, 1, lvl_n)
        ue_cont = is5 & b1
        lvl_n = jnp.where(ue_cont, lvl + 1, lvl_n)
        ue_to_um_hi = ue_cont & (lvl_n == MAX_EK)
        ue_stop = is5 & ~b1
        enter_um = ue_to_um_hi | ue_stop
        ek_run = jnp.where(ue_to_um_hi, MAX_EK, lvl)
        ek_n = jnp.where(enter_um, ek_run, ek_n)
        kval_n = jnp.where(enter_um, 1, kval)
        kleft_n = jnp.where(enter_um, ek_run, kleft)
        kval_n = jnp.where(is6, kval * 2 + bit, kval_n)
        kleft_n = jnp.where(is6, kleft - 1, kleft_n)
        um_done = is6 & (kleft_n == 0)
        k_done = jnp.where(ut_one, 1, jnp.where(um_done, kval_n, 0))
        complete = active & (ut_one | um_done)
        k_done = jnp.clip(k_done, 0, jnp.maximum(nsym_lane - opos, 1))
        # emit group: rank at opos (0 writes are no-ops value-wise)
        out = jnp.where(
            complete[:, None] & (ocol == opos[:, None]) & (r_n[:, None] > 0),
            r_n[:, None], out)
        opos_n = jnp.where(complete, opos + k_done, opos)
        # context roll
        prev2_r_n = jnp.where(complete, prev_r, prev2_r)
        prev2_k_n = jnp.where(complete, prev_k, prev2_k)
        prev_r_n = jnp.where(complete, r_n, prev_r)
        prev_k_n = jnp.where(complete, k_done, prev_k)
        prev_e_n = jnp.where(
            complete,
            jnp.where(r_n > 0, _bitlen(jnp.maximum(r_n, 1)) - 1, 0),
            prev_e)
        phase_n = jnp.where(
            complete, 1,
            jnp.where(to_rt, 1,
                      jnp.where(to_re, 2,
                                jnp.where(enter_rm, 3,
                                          jnp.where(to_ut & ~complete, 4,
                                                    jnp.where(to_ue, 5,
                                                              jnp.where(enter_um, 6, phase)))))))
        # to_ut from rank side (not completion): phase 4
        phase_n = jnp.where((to_ut & ~complete), 4, phase_n)
        r_n2 = jnp.where(complete, 0, r_n)
        upd = active
        return (x, rpos, out,
                jnp.where(upd, opos_n, opos),
                jnp.where(upd, phase_n, phase),
                jnp.where(upd, lvl_n, lvl),
                jnp.where(upd, val_n, val),
                jnp.where(upd, mleft_n, mleft),
                jnp.where(upd, ek_n, ek),
                jnp.where(upd, kval_n, kval),
                jnp.where(upd, kleft_n, kleft),
                jnp.where(upd, r_n2, r),
                jnp.where(upd, prev_r_n, prev_r),
                jnp.where(upd, prev2_r_n, prev2_r),
                jnp.where(upd, prev_k_n, prev_k),
                jnp.where(upd, prev2_k_n, prev2_k),
                jnp.where(upd, prev_e_n, prev_e),
                pstate, cstate)

    carry = (st0["x"], st0["rpos"], st0["out"], st0["opos"],
             st0["phase"], st0["lvl"], st0["val"], st0["mleft"],
             st0["ek"], st0["kval"], st0["kleft"], st0["r"],
             st0["prev_r"], st0["prev2_r"], st0["prev_k"],
             st0["prev2_k"], st0["prev_e"], pstate, cstate)

    def b4(sidx, cc):
        for q in range(4):
            cc = body2(sidx * 4 + q, cc)
        return cc

    carry = jax.lax.fori_loop(0, (nsteps + 3) // 4, b4, carry)
    out = carry[2]
    return out.reshape(cap)


def stats_host(ranks: np.ndarray, m: int, chunk: int = GCHUNK):
    """Host (numpy) event statistics: exact (model, bit) multiset of
    `_binarize` without materializing the device grid.  Returns
    (ones[NM], tot[NM], cones[NFAM], ctot[NFAM], max_lane_bits)."""
    cap = len(ranks)
    pos = np.arange(cap)
    valid = pos < m
    rk = np.where(valid, ranks.astype(np.int64), 0)
    ilp = pos % chunk
    is_start = ((rk != 0) | (ilp == 0)) & valid

    lane_end = (pos // chunk + 1) * chunk
    start_pos = np.where(is_start, pos, cap + 1)
    nxt = np.minimum.accumulate(start_pos[::-1])[::-1]
    nxt_after = np.append(nxt[1:], cap + 1)
    k = np.clip(np.minimum(np.minimum(nxt_after, lane_end), m) - pos,
                1, chunk)
    lane_first = (pos // chunk) * chunk
    S = np.maximum.accumulate(
        np.concatenate([[-1], np.where(is_start, pos, -1)[:-1]]))
    S = np.where(S >= lane_first, S, -1)
    Sc = np.maximum(S, 0)
    S2 = np.where(S >= 0, S[Sc], -1)
    S2 = np.where(S2 >= lane_first, S2, -1)
    S2c = np.maximum(S2, 0)
    prev_r = np.where(S >= 0, rk[Sc], 0)
    prev_k = np.where(S >= 0, k[Sc], 1)
    prev2_r = np.where(S2 >= 0, rk[S2c], 0)
    prev2_k = np.where(S2 >= 0, k[S2c], 1)
    with np.errstate(divide="ignore"):
        prev_e = np.where(prev_r > 0,
                          np.frexp(np.maximum(prev_r, 1))[1] - 1, 0)
    q1 = np.minimum(prev_r, 3)
    q2_ = np.minimum(prev2_r, 3)
    cR4 = q1 * 4 + q2_
    cRun = (prev_k < 3).astype(np.int64) * 2 + (prev2_k < 3)
    hE = np.minimum(prev_e, 3)
    cR4c = np.minimum(q1 * 2 + (prev2_r > 0), 3)
    cR0 = ((prev_r == 1) * 4 + (prev2_r == 1) * 2
           + (prev_r > 4)).astype(np.int64)
    rq = np.minimum(np.maximum(rk - 1, 0), 2) + (rk == 0)

    r = rk
    E = np.where(r > 1, np.frexp(np.maximum(r, 1))[1] - 1, 0)
    nRE = np.where(r > 1, (E - 1) + (E < 7), 0)
    Ek = np.where(k > 1, np.frexp(np.maximum(k, 1))[1] - 1, 0)
    nUE = np.where(k > 1, (Ek - 1) + (Ek < MAX_EK), 0)
    has_l0 = (ilp == 0) & is_start
    has_rank = is_start & (r > 0)

    models, bits = [], []

    def emit(mask, model, bit):
        idx = np.flatnonzero(mask)
        models.append(model[idx] if isinstance(model, np.ndarray)
                      else np.full(len(idx), model))
        bits.append(np.asarray(bit[idx] if isinstance(bit, np.ndarray)
                               else np.full(len(idx), bit)))

    emit(has_l0, np.full(cap, B_L0), (r == 0).astype(np.int64))
    emit(has_rank, B_RT + cR4 * 16 + cRun * 4 + hE, (r == 1))
    for lvl in range(1, 7):
        emit(has_rank & (nRE >= lvl), B_RE + (lvl - 1) * 4 + cR4c,
             (E > lvl))
    for t in range(7):
        mk = has_rank & (E > t)
        path = np.minimum(r >> np.maximum(E - t, 0), 63)
        bit = (r >> np.maximum(E - 1 - t, 0)) & 1
        ee = np.maximum(E, 1)
        emit(mk, B_RM + (ee - 1) * 64 + path, bit)
    emit(is_start, B_UT + rq * 32 + cRun * 8 + cR0, (k == 1))
    for lvl in range(1, MAX_EK):
        emit(is_start & (nUE >= lvl), B_UE + (lvl - 1) * 4 + rq,
             (Ek > lvl))
    for t in range(MAX_EK):
        mk = is_start & (Ek > t)
        path = np.minimum(k >> np.maximum(Ek - t, 0), 31)
        bit = (k >> np.maximum(Ek - 1 - t, 0)) & 1
        ee = np.maximum(Ek, 1)
        emit(mk, B_UM + (ee - 1) * 32 + path, bit)

    mid = np.concatenate(models).astype(np.int64)
    bb = np.concatenate(bits).astype(np.int64)
    tot = np.bincount(mid, minlength=NM)
    ones = np.bincount(mid, weights=bb, minlength=NM).astype(np.int64)
    famv = fam_of_model()
    ctot = np.bincount(famv[mid], minlength=NFAM)
    cones = np.bincount(famv[mid], weights=bb,
                        minlength=NFAM).astype(np.int64)
    ev = (has_l0.astype(np.int64) + has_rank * (1 + nRE + E)
          + is_start * (1 + nUE + Ek))
    lane_bits = ev.reshape(-1, chunk).sum(axis=1)
    return (ones, tot, cones, ctot,
            int(lane_bits.max()) if len(lane_bits) else 0)


def _reverse_rans_t(gmb_t: jax.Array, probs_t: jax.Array,
                    nsteps: jax.Array, L: int, W: int):
    """`_reverse_rans` over TIME-MAJOR grids (gmb_t/probs_t [Wp, Lp]):
    each step reads a contiguous ROW via dynamic_slice instead of a
    strided column gather (2 x nsteps of them dominated the -e2 encode
    after the walk moved to Pallas — GRC_TRACE_r5).  Returns
    (words uint16[L, W+2], counts int32[L], states uint32[L])."""
    Wp, Lp = gmb_t.shape
    x0 = jnp.full((Lp,), RANS_L, jnp.uint32)
    emit0 = jnp.zeros((Wp, Lp), jnp.uint16)
    emask0 = jnp.zeros((Wp, Lp), bool)

    def ebody(i, st):
        x, emit, emask = st
        t = jnp.maximum(nsteps - 1 - i, 0)
        e = jax.lax.dynamic_slice_in_dim(gmb_t, t, 1, axis=0)[0]
        vq = (e > 0) & (nsteps - 1 - i >= 0)
        b = (e & 1).astype(jnp.uint32)
        p1 = jax.lax.dynamic_slice_in_dim(
            probs_t, t, 1, axis=0)[0].astype(jnp.uint32)
        f = jnp.where(b == 1, p1, SCALE - p1)
        c = jnp.where(b == 1, SCALE - p1, 0).astype(jnp.uint32)
        x_max = f << jnp.uint32(32 - PROB_BITS)
        do_emit = vq & (x >= x_max)
        emit = jax.lax.dynamic_update_slice(
            emit, (x & 0xFFFF).astype(jnp.uint16)[None, :], (i, 0))
        emask = jax.lax.dynamic_update_slice(
            emask, do_emit[None, :], (i, 0))
        x = jnp.where(do_emit, x >> jnp.uint32(16), x)
        fx = jnp.maximum(f, 1)
        x_new = ((x // fx) << jnp.uint32(PROB_BITS)) + (x % fx) + c
        x = jnp.where(vq, x_new, x)
        return x, emit, emask

    def e4(s, st):
        for q in range(4):
            st = ebody(s * 4 + q, st)
        return st

    x, emit, emask = jax.lax.fori_loop(0, (nsteps + 3) // 4, e4,
                                       (x0, emit0, emask0))
    # emission index i < nsteps <= W: the Wp padding rows are never
    # written, so slicing back to W keeps bit-identity with
    # `_reverse_rans` (same [L, W+2] shape)
    emit_t = emit.T[:L, :W]
    emask_t = emask.T[:L, :W]
    counts = jnp.sum(emask_t.astype(jnp.int32), axis=1)
    pos_in_lane = jnp.cumsum(emask_t.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(emask_t, counts[:, None] - 1 - pos_in_lane, W + 2)
    words = jnp.zeros((L, W + 2), jnp.uint16)
    words = words.at[
        jnp.arange(L, dtype=jnp.int32)[:, None], tgt
    ].set(emit_t, mode="drop")
    return words, counts, x[:L]
