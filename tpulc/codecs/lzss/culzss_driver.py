"""CULZSS codec driver: container payloads with per-packet size table.

Payload layout per block (little-endian) — the tpulc equivalent of
CULZSS's bookkeeping header (`culzss.c:220-264`):

    npackets  u32
    sizes     u16 * npackets   (bit 15 set = raw 4096-byte packet, the
                                "compression took more" fallback)
    packets   back to back
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from tpulc.codecs.lzss.culzss import (
    PCKT,
    culzss_decode_block,
    culzss_encode_block,
)
from tpulc.pipeline.container import Container
from tpulc.pipeline.registry import CODEC_LZSS_CULZSS
from tpulc.primitives.checksum import adler32_np

RAW_FLAG = 0x8000


def compress_block(block: np.ndarray, block_cap: int) -> bytes:
    n = block.shape[0]
    # pad only to the packet grid actually covered by data (a short
    # tail block must not encode a block_cap's worth of zero packets)
    cap = -(-max(n, 1) // PCKT) * PCKT
    padded = np.zeros(cap, np.uint8)
    padded[:n] = block
    out, sizes, _ntok = culzss_encode_block(jnp.asarray(padded))
    out = np.asarray(out)
    sizes = np.asarray(sizes)
    P = cap // PCKT
    parts = [struct.pack("<I", P)]
    size_tab = np.zeros(P, "<u2")
    bodies = []
    for j in range(P):
        s = int(sizes[j])
        if s >= PCKT:  # incompressible packet: store raw
            size_tab[j] = RAW_FLAG | PCKT
            bodies.append(padded[j * PCKT: (j + 1) * PCKT].tobytes())
        else:
            size_tab[j] = s
            bodies.append(out[j, :s].tobytes())
    parts.append(size_tab.tobytes())
    parts.extend(bodies)
    return b"".join(parts)


def decompress_block(payload: bytes, raw_size: int, block_cap: int) -> np.ndarray:
    (P,) = struct.unpack("<I", payload[:4])
    sizes = np.frombuffer(payload[4: 4 + 2 * P], "<u2")
    off = 4 + 2 * P
    cap_out = PCKT + PCKT // 8 + 8
    pbuf = np.zeros((P, cap_out), np.uint8)
    psizes = np.zeros(P, np.int32)
    raw = {}
    for j in range(P):
        s = int(sizes[j])
        if s & RAW_FLAG:
            s &= 0x7FFF
            raw[j] = np.frombuffer(payload[off: off + s], np.uint8)
            psizes[j] = 0
        else:
            pbuf[j, :s] = np.frombuffer(payload[off: off + s], np.uint8)
            psizes[j] = s
        off += s & 0x7FFF
    blocks, outl = culzss_decode_block(
        jnp.asarray(pbuf), jnp.asarray(psizes)
    )
    blocks = np.array(blocks)  # writable copy for raw-packet patching
    for j, data in raw.items():
        blocks[j] = data
    return blocks.reshape(-1)[:raw_size]


def compress(data: bytes | np.ndarray, block_size: int = 1 << 20) -> bytes:
    """All blocks' packets encode in ONE device call (mirror of the
    batched decode below) instead of 4+ serial dispatch+pull round
    trips per block."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    n = arr.shape[0]
    starts = list(range(0, max(n, 1), block_size))
    caps = [-(-max(min(n - s, block_size), 1) // PCKT) * PCKT
            for s in starts]
    Ptot = sum(c // PCKT for c in caps)
    Ppad = 1 << max(1, (Ptot - 1).bit_length())
    grid = np.zeros(Ppad * PCKT, np.uint8)
    o = 0
    for s, cap in zip(starts, caps):
        chunk = arr[s: s + block_size]
        grid[o: o + chunk.shape[0]] = chunk
        o += cap
    out, sizes, _ = culzss_encode_block(jnp.asarray(grid))
    out = np.asarray(out)
    sizes = np.asarray(sizes)
    payloads = []
    o = 0
    for s, cap in zip(starts, caps):
        P = cap // PCKT
        parts = [struct.pack("<I", P)]
        size_tab = np.zeros(P, "<u2")
        bodies = []
        for j in range(P):
            sz = int(sizes[o + j])
            if sz >= PCKT:  # incompressible packet: store raw
                size_tab[j] = RAW_FLAG | PCKT
                bodies.append(
                    grid[(o + j) * PCKT: (o + j + 1) * PCKT].tobytes())
            else:
                size_tab[j] = sz
                bodies.append(out[o + j, :sz].tobytes())
        parts.append(size_tab.tobytes())
        parts.extend(bodies)
        payloads.append(b"".join(parts))
        o += P
    c = Container(
        codec_id=CODEC_LZSS_CULZSS, flags=0, orig_len=n,
        block_size=block_size, comp_sizes=[len(p) for p in payloads],
        payloads=payloads, data_adler=adler32_np(arr),
    )
    return c.to_bytes()


def decompress(buf: bytes) -> bytes:
    """All blocks' packets decode in ONE device call (the packet-lane
    decode is latency-bound; total packet count buckets to a power of
    two so the whole corpus shares one compiled program)."""
    c = Container.from_bytes(buf)
    assert c.codec_id == CODEC_LZSS_CULZSS
    cap_out = PCKT + PCKT // 8 + 8
    allp = []
    for payload in c.payloads:
        (P,) = struct.unpack("<I", payload[:4])
        sizes = np.frombuffer(payload[4: 4 + 2 * P], "<u2")
        off = 4 + 2 * P
        pbuf = np.zeros((P, cap_out), np.uint8)
        psizes = np.zeros(P, np.int32)
        raw = {}
        for j in range(P):
            s = int(sizes[j])
            if s & RAW_FLAG:
                s &= 0x7FFF
                raw[j] = np.frombuffer(payload[off: off + s], np.uint8)
            else:
                pbuf[j, :s] = np.frombuffer(payload[off: off + s],
                                            np.uint8)
                psizes[j] = s
            off += s & 0x7FFF
        allp.append((P, pbuf, psizes, raw))
    Ptot = sum(p[0] for p in allp)
    Ppad = 1 << max(1, (Ptot - 1).bit_length())
    pbuf_all = np.zeros((Ppad, cap_out), np.uint8)
    psz_all = np.zeros(Ppad, np.int32)
    o = 0
    for P, pbuf, psizes, _ in allp:
        pbuf_all[o: o + P] = pbuf
        psz_all[o: o + P] = psizes
        o += P
    blocks, _ = culzss_decode_block(
        jnp.asarray(pbuf_all), jnp.asarray(psz_all)
    )
    blocks = np.array(blocks)
    o = 0
    parts = []
    for info, (P, _, _, raw) in zip(c.block_infos(), allp):
        blk = blocks[o: o + P]
        for j, data in raw.items():
            blk[j] = data
        cap = -(-c.block_size // PCKT) * PCKT
        parts.append(blk.reshape(-1)[: min(info.raw_size, cap)])
        o += P
    out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
    if not c.verify_data(np.frombuffer(out, np.uint8)):
        raise ValueError("data checksum mismatch after decompress")
    return out