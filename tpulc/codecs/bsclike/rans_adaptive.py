"""Adaptive binary rANS coder — the bsc `-e2` coder mode.

libbsc's best ratios come from QLFC's *adaptive* binary range coder
(`cuda-bsc/libbsc/coder/qlfc/qlfc.cpp:448-752`, models in
`qlfc_model.h`): every binary decision updates its model, so
probabilities track local statistics.  Serial adaptation does not
vectorize across a block — but it DOES vectorize across lanes: cut the
symbol stream into fixed lanes, restart every lane's models from
block-static initial probabilities (wired, one u16 per model), and run
all lanes' bit decisions in lockstep.  Offline pricing on the bench
corpus (an information-content simulation, since removed): static
order-2 rANS 176.7 KB,
this coder 167.9 KB, libbsc's global-adaptation regime 164.9 KB.

Event decomposition per RLE2 symbol s (alphabet 0..256), the
QLFC-style exponent/mantissa binarization:

    E0   bit (s == 0)            model: cls(prev) x cls4(prev2)  [32]
    E1   bit (s == 1)   if s>0   model: 32 + cls(prev)           [8]
    EXP  continuation   if s>1   model: 40 + lvl*4 + cls4(prev)  [28]
         bits of E = bit_length(s-1): lvl<E-1 -> 1, stop 0 at
         lvl=E-1 (omitted when lvl would be 7: E=8 is implied)
    MANT bits of s-1 below the top bit (MSB first)
                                 model: 68 + (E-2)*7 + pos       [49]

117 models, <= 16 bits per symbol.  Adaptation (identical integer ops
on both sides): p += ((bit << 12) - p) >> 5, p in [~16, 4096-16], so
binary rANS frequencies never hit 0 or full scale.

Encode is three lockstep passes in ONE jitted program: (1) vectorized
binarization scatters (model, bit) pairs into a [nlanes, W] grid at
segment-cumsum offsets; (2) a forward modeling pass materializes the
adapted probability of every bit; (3) the reverse (LIFO) rANS pass
consumes bits+probabilities.  Decode is a single forward pass whose
per-lane FSM re-derives each bit's model id, decodes the bit, updates
the model identically, and reassembles symbols.

Lanes hold ACHUNK = 1024 symbols: 2x fewer restarts than the static
coder's 512 (adaptation warm-up amortizes; sim: 1024 beats 512 by
1.6%), at a serial decode depth of max-bits-per-lane (~7/sym worst
lane on text).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

ACHUNK = 1024          # symbols per lane
PROB_BITS_A = 12
SCALE_A = 1 << PROB_BITS_A
RATE = 5               # adaptation shift
RANS_L = 1 << 16
MAX_SYM_BITS = 16      # 2 + 7 exp + 7 mantissa

NM_E0, NM_E1, NM_EXP, NM_MANT = 32, 8, 28, 49
NMODELS = NM_E0 + NM_E1 + NM_EXP + NM_MANT  # 117
_M_E1 = NM_E0
_M_EXP = NM_E0 + NM_E1
_M_MANT = NM_E0 + NM_E1 + NM_EXP

_CTX_EDGES = (1, 2, 3, 4, 6, 10, 18)  # same rank-class buckets as rans.py


def _cls(s: jax.Array) -> jax.Array:
    c = jnp.zeros(s.shape, jnp.int32)
    for e in _CTX_EDGES:
        c = c + (s >= e).astype(jnp.int32)
    return c


def _bitlen(v: jax.Array) -> jax.Array:
    """bit_length of int32 v >= 1."""
    return 32 - jax.lax.clz(v.astype(jnp.uint32)).astype(jnp.int32)


def _classes(syms2: jax.Array):
    """[B, cap] symbols -> (c1 full class of prev, c2 capped class of
    prev2), contexts flowing across lanes WITHIN a block only."""
    z1 = jnp.zeros((syms2.shape[0], 1), syms2.dtype)
    prev = jnp.concatenate([z1, syms2[:, :-1]], axis=1)
    prev2 = jnp.concatenate([z1, z1, syms2[:, :-2]], axis=1)
    return _cls(prev), jnp.minimum(_cls(prev2), 3)


def _slot_tables(s, c1, c2):
    """Per-symbol slot q in [0,16): (model, bit, valid) int32 arrays of
    s's shape, stacked on a leading axis (static python loop)."""
    v1 = jnp.maximum(s - 1, 1)
    E = _bitlen(v1)
    nexp = jnp.minimum(E, 7)
    c1c = jnp.minimum(c1, 3)
    models, bits, valids = [], [], []
    for q in range(MAX_SYM_BITS):
        if q == 0:
            mq = c1 * 4 + c2
            bq = (s == 0).astype(jnp.int32)
            vq = jnp.ones(s.shape, bool)
        elif q == 1:
            mq = _M_E1 + c1
            bq = (s == 1).astype(jnp.int32)
            vq = s > 0
        else:
            lvl = q - 2
            in_exp = (s > 1) & (lvl < nexp)
            mpos = q - 2 - nexp  # mantissa position when >= 0
            in_mant = (s > 1) & (mpos >= 0) & (mpos <= E - 2)
            m_exp = _M_EXP + jnp.minimum(lvl, 6) * 4 + c1c
            b_exp = (lvl < E - 1).astype(jnp.int32)
            m_mant = _M_MANT + (E - 2) * 7 + jnp.maximum(mpos, 0)
            b_mant = (v1 >> jnp.clip(E - 2 - mpos, 0, 31)) & 1
            mq = jnp.where(in_exp, m_exp, jnp.where(in_mant, m_mant, 0))
            bq = jnp.where(in_exp, b_exp, b_mant)
            vq = in_exp | in_mant
        models.append(mq)
        bits.append(bq)
        valids.append(vq)
    return (jnp.stack(models), jnp.stack(bits), jnp.stack(valids))


def _nbits_of(s: jax.Array) -> jax.Array:
    """Bits emitted per symbol: 1 (s=0), 2 (s=1), else 2+min(E,7)+E-1."""
    v1 = jnp.maximum(s - 1, 1)
    E = _bitlen(v1)
    return jnp.where(
        s == 0, 1, jnp.where(s == 1, 2, 2 + jnp.minimum(E, 7) + E - 1)
    )


@partial(jax.jit, static_argnames=("chunk",))
def abc_stats(syms2: jax.Array, ms: jax.Array, chunk: int = ACHUNK):
    """Pre-encode statistics, one cheap program before the W-shaped
    encode: per-block model bit rates (for wire'd inits), per-lane bit
    counts (host buckets W = max), per-lane starting context classes.

    syms2 int32[B, cap]; ms int32[B].
    Returns (ones [B, NMODELS], tot [B, NMODELS], lane_bits [B*lcap],
    lane_cls [B*lcap]).
    """
    B, cap = syms2.shape
    lcap = cap // chunk
    c1, c2 = _classes(syms2)
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = pos < ms[:, None]

    models, bits, valids = _slot_tables(syms2, c1, c2)  # [16, B, cap]
    v = valids & valid[None, :, :]
    # per-block model histograms: segment-sum over B*NMODELS keys
    blk = jnp.arange(B, dtype=jnp.int32)[None, :, None]
    key = blk * NMODELS + models
    key = jnp.where(v, key, B * NMODELS)
    ks, bs = jax.lax.sort(
        (key.reshape(-1), bits.reshape(-1).astype(jnp.int32)), num_keys=1
    )
    edges = jnp.searchsorted(
        ks, jnp.arange(B * NMODELS + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    csum = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(bs)])
    ones = (csum[edges[1:]] - csum[edges[:-1]]).reshape(B, NMODELS)
    tot = jnp.diff(edges).reshape(B, NMODELS)

    nb = jnp.where(valid, _nbits_of(syms2), 0)
    lane_bits = nb.reshape(B * lcap, chunk).sum(axis=1)
    lane_cls = (c1 * 4 + c2).reshape(B * lcap, chunk)[:, 0]
    return ones, tot, lane_bits, lane_cls


def quantize_inits(ones: np.ndarray, tot: np.ndarray) -> np.ndarray:
    """[B, NMODELS] counts -> u16 initial probabilities (of bit=1)."""
    t = np.maximum(tot, 1)
    p = np.rint(ones / t * SCALE_A).astype(np.int64)
    p = np.clip(p, 16, SCALE_A - 16)
    return np.where(tot == 0, SCALE_A // 2, p).astype(np.uint16)


def _adapt(p: jax.Array, bit: jax.Array, upd: jax.Array) -> jax.Array:
    """p int32; identical integer ops on encode and decode.  The shift
    rounds toward -inf, so repeated 0-bits would walk p to 0 (a
    zero-frequency rANS symbol) — clamp keeps both branches codable."""
    step = ((bit << PROB_BITS_A) - p) >> RATE
    return jnp.where(upd, jnp.clip(p + step, 8, SCALE_A - 8), p)


@partial(jax.jit, static_argnames=("chunk", "W"))
def abc_encode(syms2: jax.Array, ms: jax.Array, inits: jax.Array,
               W: int, chunk: int = ACHUNK):
    """Encode [B, cap] symbol blocks -> per-lane adaptive-binary rANS.

    inits uint16[B, NMODELS] (the wire'd tables).  W: static grid
    width >= max bits per lane (host buckets `abc_stats` lane_bits).
    Returns (words uint16[L, W+2], counts int32[L], states uint32[L])
    with L = B * (cap // chunk) lanes block-major.
    """
    B, cap = syms2.shape
    lcap = cap // chunk
    L = B * lcap
    c1, c2 = _classes(syms2)
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = pos < ms[:, None]

    # ---- pass 1: binarize into [L, W] grids --------------------------
    nb = jnp.where(valid, _nbits_of(syms2), 0).reshape(L, chunk)
    offs = jnp.cumsum(nb, axis=1) - nb              # within-lane offsets
    models, bits, valids = _slot_tables(syms2, c1, c2)
    v = valids & valid[None, :, :]                  # [16, B, cap]
    mflat = models.reshape(MAX_SYM_BITS, L, chunk)
    bflat = bits.reshape(MAX_SYM_BITS, L, chunk)
    vflat = v.reshape(MAX_SYM_BITS, L, chunk)
    # packed (model, bit) byte; 0 marks an empty slot (model 0 bit 0 is
    # E0/ctx0 — shift ids by 1 to keep 0 free)
    gmb = jnp.zeros((L, W), jnp.int32)
    lane_ids = jnp.arange(L, dtype=jnp.int32)[:, None]
    qoff = jnp.zeros((L, chunk), jnp.int32)
    for q in range(MAX_SYM_BITS):
        tgt = jnp.where(vflat[q], offs + qoff, W)
        rec = (mflat[q] + 1) * 2 + bflat[q]
        gmb = gmb.at[lane_ids, tgt].set(
            jnp.where(vflat[q], rec, 0), mode="drop"
        )
        qoff = qoff + vflat[q].astype(jnp.int32)
    # (model, bit, valid) decode per step from the ONE packed grid —
    # separate gm/gb/gvalid grids would triple the [L, W] footprint
    # (matters at 25 MB blocks: [24k lanes, 16k bits]).
    lane_bits = nb.sum(axis=1)

    # ---- pass 2: forward modeling (materialize probabilities) --------
    blk_of_lane = jnp.arange(L, dtype=jnp.int32) // lcap
    pstate0 = inits[blk_of_lane].astype(jnp.int32)   # [L, NMODELS]
    probs0 = jnp.zeros((W, L), jnp.uint16)
    nsteps = jnp.max(lane_bits)

    mcol = jnp.arange(NMODELS, dtype=jnp.int32)[None, :]

    def mbody(t, st):
        pstate, probs = st
        e = gmb[:, t]
        m = jnp.maximum(e // 2 - 1, 0)
        upd = e > 0
        # one-hot select instead of gather/scatter: masked ops over
        # the small [L, NMODELS] state stay elementwise per loop step.
        hit = mcol == m[:, None]
        p = jnp.sum(jnp.where(hit, pstate, 0), axis=1)
        probs = jax.lax.dynamic_update_slice(
            probs, p.astype(jnp.uint16)[None, :], (t, 0)
        )
        newv = _adapt(p, e & 1, upd)
        pstate = jnp.where(hit & upd[:, None], newv[:, None], pstate)
        return pstate, probs

    # dynamic trip count forbids fori_loop's own unroll; 4 substeps per
    # iteration amortize the while-loop per-step overhead instead.
    # Overshoot rows (t in [nsteps, ceil4)) are no-ops: gmb is 0 there.
    def m4(s, st):
        for q in range(4):
            st = mbody(s * 4 + q, st)
        return st

    _, probs = jax.lax.fori_loop(0, (nsteps + 3) // 4, m4,
                                 (pstate0, probs0))
    probs = probs.T                                  # [L, W]

    # ---- pass 3: reverse rANS over (bit, prob) -----------------------
    x0 = jnp.full((L,), RANS_L, jnp.uint32)
    emit0 = jnp.zeros((W, L), jnp.uint16)
    emask0 = jnp.zeros((W, L), bool)

    def ebody(i, st):
        x, emit, emask = st
        t = nsteps - 1 - i                           # reverse bit order
        e = gmb[:, jnp.maximum(t, 0)]
        # unrolled overshoot (i >= nsteps -> t < 0) must not re-code
        # bit 0: the clamped read IS a valid slot there
        vq = (e > 0) & (t >= 0)
        b = (e & 1).astype(jnp.uint32)
        p1 = probs[:, t].astype(jnp.uint32)
        f = jnp.where(b == 1, p1, SCALE_A - p1)
        c = jnp.where(b == 1, SCALE_A - p1, 0).astype(jnp.uint32)
        x_max = f << jnp.uint32(32 - PROB_BITS_A)
        do_emit = vq & (x >= x_max)
        emit = jax.lax.dynamic_update_slice(
            emit, (x & 0xFFFF).astype(jnp.uint16)[None, :], (i, 0)
        )
        emask = jax.lax.dynamic_update_slice(
            emask, do_emit[None, :], (i, 0)
        )
        x = jnp.where(do_emit, x >> jnp.uint32(16), x)
        fx = jnp.maximum(f, 1)
        x_new = ((x // fx) << jnp.uint32(PROB_BITS_A)) + (x % fx) + c
        x = jnp.where(vq, x_new, x)
        return x, emit, emask

    def e4(s, st):
        for q in range(4):
            st = ebody(s * 4 + q, st)
        return st

    x, emit, emask = jax.lax.fori_loop(0, (nsteps + 3) // 4, e4,
                                       (x0, emit0, emask0))
    emit_t = emit.T                                  # [L, W] emission order
    emask_t = emask.T
    counts = jnp.sum(emask_t.astype(jnp.int32), axis=1)
    pos_in_lane = jnp.cumsum(emask_t.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(emask_t, counts[:, None] - 1 - pos_in_lane, W + 2)
    words = jnp.zeros((L, W + 2), jnp.uint16)
    words = words.at[
        jnp.arange(L, dtype=jnp.int32)[:, None], tgt
    ].set(emit_t, mode="drop")
    return words, counts, x


@partial(jax.jit, static_argnames=("chunk", "B"))
def abc_decode(words: jax.Array, counts: jax.Array, states: jax.Array,
               lane_cls: jax.Array, ms: jax.Array, inits: jax.Array,
               nsteps: jax.Array, B: int, chunk: int = ACHUNK):
    """Forward FSM decode: one bit per lockstep step.

    words uint16[L, W+2] (L = B*lcap lanes block-major); lane_cls
    int32[L] packed c1*4+c2 entering each lane; ms int32[B]; inits
    uint16[B, NMODELS]; nsteps — max bits in any lane (wire'd).
    Returns syms int32[B, lcap*chunk].
    """
    L = words.shape[0]
    lcap = L // B
    rows = jnp.arange(L, dtype=jnp.int32)
    blk = rows // lcap
    nsym_lane = jnp.clip(ms[blk] - (rows % lcap) * chunk, 0, chunk)
    pstate = inits[blk].astype(jnp.int32)            # [L, NMODELS]

    x0 = states.astype(jnp.uint32)
    rpos0 = jnp.zeros((L,), jnp.int32)
    out0 = jnp.zeros((L, chunk), jnp.int32)
    sym_i0 = jnp.zeros((L,), jnp.int32)
    phase0 = jnp.zeros((L,), jnp.int32)              # 0 E0, 1 E1, 2 EXP, 3 MANT
    lvl0 = jnp.zeros((L,), jnp.int32)
    v1acc0 = jnp.zeros((L,), jnp.int32)
    ee0 = jnp.zeros((L,), jnp.int32)                 # exponent E when known
    mpos0 = jnp.zeros((L,), jnp.int32)
    c1_0 = lane_cls // 4
    c2_0 = lane_cls % 4
    Wp2 = words.shape[1]
    mcol = jnp.arange(NMODELS, dtype=jnp.int32)[None, :]
    ocol = jnp.arange(chunk, dtype=jnp.int32)[None, :]

    def body(t, st):
        (x, rpos, pstate, out, sym_i, phase, lvl, v1acc, ee, mpos,
         c1, c2) = st
        active = sym_i < nsym_lane
        # model id from FSM state
        m_e0 = c1 * 4 + c2
        m_e1 = _M_E1 + c1
        m_exp = _M_EXP + jnp.minimum(lvl, 6) * 4 + jnp.minimum(c1, 3)
        m_mant = _M_MANT + (ee - 2) * 7 + mpos
        m = jnp.where(
            phase == 0, m_e0,
            jnp.where(phase == 1, m_e1,
                      jnp.where(phase == 2, m_exp, m_mant)),
        )
        m = jnp.clip(m, 0, NMODELS - 1)
        hit = mcol == m[:, None]
        p1 = jnp.sum(jnp.where(hit, pstate, 0), axis=1).astype(jnp.uint32)
        f0 = jnp.uint32(SCALE_A) - p1
        # decode bit: slot < f0 -> bit 0
        slot = x & jnp.uint32(SCALE_A - 1)
        bit = (slot >= f0).astype(jnp.int32)
        f = jnp.where(bit == 1, p1, f0)
        c = jnp.where(bit == 1, f0, 0)
        x_new = f * (x >> jnp.uint32(PROB_BITS_A)) + slot - c
        need = active & (x_new < jnp.uint32(RANS_L))
        w = words[rows, jnp.minimum(rpos, Wp2 - 1)].astype(jnp.uint32)
        x_new2 = jnp.where(need, (x_new << jnp.uint32(16)) | w, x_new)
        rpos = rpos + need.astype(jnp.int32)
        x = jnp.where(active, x_new2, x)
        newv = _adapt(p1.astype(jnp.int32), bit, active)
        pstate = jnp.where(hit & active[:, None], newv[:, None], pstate)
        # FSM transition
        is0, is1 = phase == 0, phase == 1
        is2, is3 = phase == 2, phase == 3
        b1 = bit == 1
        # phase 2 bookkeeping
        lvl_n = jnp.where(is2 & b1, lvl + 1, lvl)
        to8 = is2 & b1 & (lvl_n == 7)                # E = 8 implied
        stop = is2 & ~b1                             # E = lvl + 1
        e_stop = lvl + 1
        # completions this step
        emit0_ = is0 & b1                            # s = 0
        emit1_ = is1 & b1                            # s = 1
        emit2_ = stop & (e_stop == 1)                # s = 2 (no mantissa)
        v1_n = jnp.where(is3, (v1acc << 1) | bit, v1acc)
        mpos_n = jnp.where(is3, mpos + 1, mpos)
        emit3_ = is3 & (mpos_n == ee - 1)            # mantissa done
        emitted = active & (emit0_ | emit1_ | emit2_ | emit3_)
        s_out = jnp.where(
            emit0_, 0,
            jnp.where(emit1_, 1, jnp.where(emit2_, 2, v1_n + 1)),
        )
        # one-hot column select (scatter fixed overhead dominates the
        # loop otherwise — see mbody note)
        out = jnp.where(
            emitted[:, None] & (ocol == sym_i[:, None]),
            s_out[:, None], out,
        )
        # next-phase selection
        phase_n = jnp.where(
            emitted, 0,
            jnp.where(is0, 1,
                      jnp.where(is1, 2,
                                jnp.where(to8 | (stop & (e_stop > 1)),
                                          3, phase))),
        )
        ee_n = jnp.where(to8, 8, jnp.where(stop, e_stop, ee))
        enter_mant = to8 | (stop & (e_stop > 1))
        v1_n = jnp.where(enter_mant, 1, v1_n)
        mpos_n = jnp.where(enter_mant, 0, mpos_n)
        lvl_n = jnp.where(emitted | (is1 & ~b1), 0, lvl_n)
        # context roll on symbol completion
        c2_n = jnp.where(emitted, jnp.minimum(c1, 3), c2)
        c1_n = jnp.where(emitted, _cls(s_out), c1)
        sym_i = sym_i + emitted.astype(jnp.int32)
        upd = active
        phase = jnp.where(upd, phase_n, phase)
        lvl = jnp.where(upd, lvl_n, lvl)
        v1acc = jnp.where(upd, v1_n, v1acc)
        ee = jnp.where(upd, ee_n, ee)
        mpos = jnp.where(upd, mpos_n, mpos)
        c1 = jnp.where(upd, c1_n, c1)
        c2 = jnp.where(upd, c2_n, c2)
        return (x, rpos, pstate, out, sym_i, phase, lvl, v1acc, ee,
                mpos, c1, c2)

    st = (x0, rpos0, pstate, out0, sym_i0, phase0, lvl0, v1acc0, ee0,
          mpos0, c1_0, c2_0)

    # 4 FSM steps per loop iteration (dynamic bound forbids fori_loop
    # unroll); steps past every lane's bit budget are no-ops (inactive)
    def b4(s, stt):
        for q in range(4):
            stt = body(s * 4 + q, stt)
        return stt

    st = jax.lax.fori_loop(0, (nsteps + 3) // 4, b4, st)
    out = st[3]
    return out.reshape(B, lcap * chunk)


def bucket_bits(maxbits: int, lo: int = 256) -> int:
    """Grid width bucket: smallest {1, 1.5}x2^k multiple of `lo` that
    covers maxbits (two compiles per octave instead of one, for <=33%
    grid slack instead of <=100% — every grid-wide op scales with W)."""
    b = lo
    while b < maxbits:
        b *= 2
    three_q = (b // 2) * 3 // 2
    if b > lo and three_q >= maxbits:
        return three_q
    return b
