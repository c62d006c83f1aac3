"""The benchmark's plain JPEG coder: float64 DCT and IDCT, an entropy
coder and decoder that work on every restart segment at once (the
decoder on a long segment, as a stream without restart markers has, in
chunks), and the stream's markers. Plain torch and NumPy on any
device; it imports nothing of the program and takes nothing the program
made.

``precision`` selects the arithmetic of the transforms: ``"float64"``
for the reference, ``"tf32"`` for the control, the nearest precision
below the float32 that the deployments state: both operands rounded to
TF32's 10-bit mantissa, products summed in float32, as a tensor core
computes a TF32 product.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tables
from .geometry import Geometry

#: blocks a transform takes at once (bounds its float64 temporaries)
CHUNK_BLOCKS = 1 << 18
#: bits of a lane where the decoder cuts a segment into chunks
CHUNK_BITS = 1024
#: a lane's stop or count that is never reached
_NEVER = 1 << 62


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest
    even."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _matmul(x: torch.Tensor, M: np.ndarray, precision: str) -> torch.Tensor:
    if precision == "float64":
        return x.to(torch.float64) @ torch.as_tensor(M, device=x.device)
    if precision == "tf32":
        return (tf32(x) @ tf32(torch.as_tensor(M, device=x.device))
                ).to(torch.float64)
    raise ValueError(f"unknown precision {precision!r}")


def plane_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) plane -> (H/8 * W/8, 64) blocks, raster order."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 64)


def blocks_plane(blocks: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return blocks.reshape(H // 8, W // 8, 8, 8).permute(0, 2, 1, 3) \
        .reshape(H, W)


def quant_tables(geo: Geometry, quality: int) -> list:
    """Zig-zag table of each component, by its class."""
    return [tables.quant_table_zz(c.kind, quality) for c in geo.components]


def quotients(planes: list, geo: Geometry, quant: list,
              precision: str = "float64") -> torch.Tensor:
    """(n_blocks, 64) float64 scan-order DCT coefficients over the
    tables, before rounding."""
    dev = planes[0].device
    parts = []
    for c in geo.components:
        M, bias = tables.fdct_operator(quant[c.index])
        b = plane_blocks(planes[c.index])
        for i in range(0, len(b), CHUNK_BLOCKS):
            parts.append(_matmul(b[i:i + CHUNK_BLOCKS], M, precision)
                         - torch.as_tensor(bias, device=dev))
    q = torch.cat(parts)
    return q[torch.as_tensor(geo.block_plane_idx, device=dev)]


def coefficients(planes: list, geo: Geometry, quant: list,
                 precision: str = "float64") -> torch.Tensor:
    """(n_blocks, 64) int32 quantised coefficients, scan order."""
    return torch.round(quotients(planes, geo, quant, precision)) \
        .to(torch.int32)


def sample_values(coeff: torch.Tensor, geo: Geometry, quant: list,
                  precision: str = "float64") -> list:
    """Scan-order coefficients -> one float64 plane a component: each
    block's IDCT plus the level shift, before rounding."""
    dev = coeff.device
    plane_order = torch.empty_like(coeff)
    plane_order[torch.as_tensor(geo.block_plane_idx, device=dev)] = coeff
    planes = []
    for c in geo.components:
        W = tables.idct_operator(quant[c.index])
        b = plane_order[c.plane_offset:c.plane_offset
                        + c.blocks_x * c.blocks_y]
        x = torch.cat([_matmul(b[i:i + CHUNK_BLOCKS], W, precision) + 128.0
                       for i in range(0, len(b), CHUNK_BLOCKS)])
        planes.append(blocks_plane(x, c.data_height, c.data_width))
    return planes


def to_planes(coeff: torch.Tensor, geo: Geometry, quant: list,
              precision: str = "float64") -> list:
    """Scan-order coefficients -> one uint8 plane a component (the
    samples rounded to nearest, ties to even, and clamped)."""
    return [torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
            for x in sample_values(coeff, geo, quant, precision)]


# ---------------------------------------------------------------------------
# Entropy coding
# ---------------------------------------------------------------------------

def _size(v: torch.Tensor) -> torch.Tensor:
    """T.81 magnitude category: bits of |v|."""
    a = v.abs().to(torch.int64)
    n = torch.zeros_like(a)
    while bool((a >> n).any()):
        n = n + ((a >> n) > 0).to(torch.int64)
    return n


def _extra(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The ``size`` extra bits of v (one's complement for v < 0)."""
    v = v.to(torch.int64)
    return torch.where(v < 0, v + (1 << size) - 1, v)


def encode_segments(coeff: torch.Tensor, geo: Geometry) -> tuple:
    """Annex K entropy coding of every segment at once: (the segments'
    stuffed bytes concatenated, uint8 tensor; each segment's length).
    Segments are padded with 1-bits to a whole byte (T.81 F.1.2.3)."""
    dev = coeff.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    nb = geo.n_blocks
    kind = t([c.kind for c in geo.components])[t(geo.block_comp)]
    code = {}
    for cls in (0, 1):
        for k in (0, 1):
            _, _, co, ln = tables.default_huffman(cls, k)
            code[cls, k] = (t(co), t(ln))

    def lookup(cls, sym, knd):
        c = torch.where(knd == 0, code[cls, 0][0][sym], code[cls, 1][0][sym])
        n = torch.where(knd == 0, code[cls, 0][1][sym], code[cls, 1][1][sym])
        return c, n

    c64 = coeff.to(torch.int64)
    # DC: the difference from the predictor
    pred = t(geo.dc_pred)
    dc = c64[:, 0]
    diff = dc - torch.where(pred >= 0, dc[pred.clamp(min=0)], 0)
    s = _size(diff)
    hc, hn = lookup(0, s, kind)
    dc_val = (hc << s) | _extra(diff, s)
    dc_len = hn + s
    # AC: one item a nonzero coefficient, its run's ZRLs folded in front
    blk, k = torch.nonzero(c64[:, 1:], as_tuple=True)
    k = k + 1
    v = c64[blk, k]
    first = torch.ones_like(blk, dtype=torch.bool)
    first[1:] = blk[1:] != blk[:-1]
    prevk = torch.where(first, torch.zeros_like(k),
                        torch.cat([k[:1], k[:-1]]))
    run = k - prevk - 1
    zrl = run >> 4
    s = _size(v)
    kb = kind[blk]
    hc, hn = lookup(1, ((run & 15) << 4) | s, kb)
    zc, zn = lookup(1, torch.full_like(s, 0xF0), kb)
    zval = torch.zeros_like(zc)
    for i in range(3):
        zval = torch.where(zrl > i, (zval << zn) | zc, zval)
    ac_val = (((zval << hn) | hc) << s) | _extra(v, s)
    ac_len = zrl * zn + hn + s
    # EOB where the last coefficient is 0
    eob = c64[:, 63] == 0
    ec, en = lookup(1, torch.zeros(nb, dtype=torch.int64, device=dev), kind)
    # items in coding order: block by block, DC, ACs, EOB
    nnz = torch.bincount(blk, minlength=nb)
    per = 1 + nnz + eob.to(torch.int64)
    off = torch.cumsum(per, 0) - per
    n_items = int(per.sum())
    val = torch.zeros(n_items, dtype=torch.int64, device=dev)
    ln = torch.zeros_like(val)
    val[off], ln[off] = dc_val, dc_len
    rank = torch.arange(len(blk), device=dev) - (torch.cumsum(nnz, 0)
                                                 - nnz)[blk]
    pos = off[blk] + 1 + rank
    val[pos], ln[pos] = ac_val, ac_len
    pe = (off + 1 + nnz)[eob]
    val[pe], ln[pe] = ec[eob], en[eob]
    # bit positions: each segment starts on a byte
    seg_of_block = torch.repeat_interleave(
        torch.arange(geo.n_segments, device=dev), t(geo.seg_count))
    seg_of_item = torch.repeat_interleave(seg_of_block, per)
    seg_bits = torch.zeros(geo.n_segments, dtype=torch.int64, device=dev)
    seg_bits.index_add_(0, seg_of_item, ln)
    seg_bytes = (seg_bits + 7) // 8
    seg_bit0 = (torch.cumsum(seg_bytes, 0) - seg_bytes) * 8
    item_end = torch.cumsum(ln, 0)
    # an item's bit: its segment's first byte, then the bits before it in
    # the segment (before it in all, less those before the segment)
    seg_item_bit0 = torch.cumsum(seg_bits, 0) - seg_bits
    item_bit = seg_bit0[seg_of_item] + (item_end - ln) \
        - seg_item_bit0[seg_of_item]
    total = int(seg_bytes.sum()) * 8
    bits = torch.ones(total, dtype=torch.uint8, device=dev)
    which = torch.repeat_interleave(torch.arange(n_items, device=dev), ln)
    j = torch.arange(len(which), device=dev) - (item_end - ln)[which]
    bits[item_bit[which] + j] = ((val[which] >> (ln[which] - 1 - j)) & 1) \
        .to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    data = (bits.reshape(-1, 8).to(torch.int32) * weights).sum(1) \
        .to(torch.uint8)
    # stuffing: a 0x00 after every 0xFF
    ff = (data == 0xFF).to(torch.int64)
    out = torch.repeat_interleave(data, 1 + ff)
    at = torch.cumsum(1 + ff, 0) - 1
    out[at[ff.bool()]] = 0
    seg_of_byte = torch.repeat_interleave(
        torch.arange(geo.n_segments, device=dev), seg_bytes)
    seg_len = torch.zeros(geo.n_segments, dtype=torch.int64, device=dev)
    seg_len.index_add_(0, seg_of_byte, 1 + ff)
    return out, seg_len


def scan_bodies(data: torch.Tensor, seg_len: torch.Tensor,
                geo: Geometry) -> list:
    """Each scan's entropy bytes with RSTm between its segments (m the
    segment's index in its scan, modulo 8)."""
    lens = seg_len.cpu().numpy()
    flat = data.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(lens)])
    bodies = []
    for s in range(len(geo.scans)):
        segs = np.nonzero(geo.seg_scan == s)[0]
        n = len(segs)
        a, b = starts[segs[0]], starts[segs[-1] + 1]
        own = lens[segs]
        marks = np.zeros(n, np.int64)
        marks[:-1] = 2
        out = np.empty(b - a + marks.sum(), np.uint8)
        dst = np.cumsum(own + marks) - own - marks
        idx = np.repeat(dst - (np.cumsum(own) - own), own) \
            + np.arange(b - a)
        out[idx] = flat[a:b]
        out[(dst + own)[:-1]] = 0xFF
        out[(dst + own)[:-1] + 1] = 0xD0 + (np.arange(n - 1) % 8)
        bodies.append(out.tobytes())
    return bodies


def _marker(m: int, payload: bytes) -> bytes:
    return bytes((0xFF, m)) + (len(payload) + 2).to_bytes(2, "big") + payload


def write_stream(bodies: list, geo: Geometry, quant: list) -> bytes:
    """A JFIF baseline stream: SOI, APP0, DQT, SOF0, DHT, DRI (none at
    restart interval 0), one SOS and body a scan, EOI. Components are
    numbered 1, 2, ...; the tables of class 0 serve luminance, those of
    class 1 chrominance."""
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x01\x01\x2c"
                                b"\x01\x2c\x00\x00")]
    kinds = sorted({c.kind for c in geo.components})
    for k in kinds:
        q = next(quant[c.index] for c in geo.components if c.kind == k)
        out.append(_marker(0xDB, bytes([k]) + bytes(q.astype(np.uint8))))
    sof = bytes([8]) + geo.height.to_bytes(2, "big") \
        + geo.width.to_bytes(2, "big") + bytes([len(geo.components)])
    for c in geo.components:
        sof += bytes([c.index + 1, (c.h << 4) | c.v, c.kind])
    out.append(_marker(0xC0, sof))
    for k in kinds:
        for cls in (0, 1):
            bits, values, _, _ = tables.default_huffman(cls, k)
            out.append(_marker(0xC4, bytes([(cls << 4) | k]) + bytes(bits)
                               + bytes(values)))
    if geo.restart_interval:
        out.append(_marker(0xDD, geo.restart_interval.to_bytes(2, "big")))
    for scan, body in zip(geo.scans, bodies):
        sos = bytes([len(scan)])
        for i in scan:
            k = geo.components[i].kind
            sos += bytes([i + 1, (k << 4) | k])
        out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
        out.append(body)
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode(planes: list, geo: Geometry, quality: int,
           precision: str = "float64") -> bytes:
    """The whole stream of a frame's component planes."""
    quant = quant_tables(geo, quality)
    data, seg_len = encode_segments(
        coefficients(planes, geo, quant, precision), geo)
    return write_stream(scan_bodies(data, seg_len, geo), geo, quant)


# ---------------------------------------------------------------------------
# Parsing and decoding
# ---------------------------------------------------------------------------

class StreamError(ValueError):
    """The stream is not a baseline stream of the expected deployment."""


@dataclasses.dataclass
class Parsed:
    """What the decoder needs of one stream: each segment's destuffed
    bytes (concatenated, with each segment's bit range), the quantisation
    table of each component and the 16-bit lookup of the DC and AC table
    of each component."""
    data: np.ndarray          # uint8, the segments' bytes back to back
    seg_bit0: np.ndarray      # (n_segments,) first bit of each segment
    seg_bits: np.ndarray      # bits of each segment
    quant: list               # zig-zag table a component (int64 arrays)
    luts: list                # (dc, ac) 65536-entry lookups a component


def _huffman_lut(payload: bytes, pos: int):
    bits = list(payload[pos:pos + 16])
    n = sum(bits)
    values = list(payload[pos + 16:pos + 16 + n])
    if len(values) != n or n > 256:
        raise StreamError("truncated DHT")
    return tables.huffman_lut16(bits, values), pos + 16 + n


def _split_scan(body: np.ndarray, n_seg: int) -> list:
    """A scan's entropy bytes -> each segment's destuffed bytes; RSTm
    must follow in order."""
    ff = np.nonzero(body[:-1] == 0xFF)[0]
    nxt = body[ff + 1]
    if np.any((nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))):
        raise StreamError("a marker inside a scan")
    rst = ff[nxt != 0]
    if len(rst) != n_seg - 1:
        raise StreamError(f"{len(rst) + 1} segments in a scan, "
                          f"{n_seg} expected")
    if np.any(body[rst + 1] != 0xD0 + np.arange(len(rst)) % 8):
        raise StreamError("restart markers out of order")
    bounds = np.concatenate([[0], rst, [len(body)]])
    starts = np.concatenate([[0], rst + 2])
    keep = np.ones(len(body), bool)
    keep[ff[nxt == 0] + 1] = False
    segs = []
    for a, b in zip(starts, bounds[1:]):
        segs.append(body[a:b][keep[a:b]])
    return segs


def parse(stream: bytes, geo: Geometry) -> Parsed:
    """Check the markers of ``stream`` against the deployment ``geo``
    (size, components and their sampling, restart interval, scans) and
    split its scans into destuffed segments; raise StreamError where it
    departs."""
    buf = np.frombuffer(stream, np.uint8)
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise StreamError("no SOI")
    pos, qt, huff, comp_q, ri = 2, {}, {}, None, None
    scans = []
    while True:
        if pos + 2 > len(buf) or buf[pos] != 0xFF:
            raise StreamError(f"no marker at byte {pos}")
        m = int(buf[pos + 1])
        if m == 0xD9:
            break
        if pos + 4 > len(buf):
            raise StreamError("truncated marker segment")
        n = int(buf[pos + 2]) << 8 | int(buf[pos + 3])
        payload = stream[pos + 4:pos + 2 + n]
        if len(payload) != n - 2:
            raise StreamError("truncated marker segment")
        pos += 2 + n
        if m == 0xDB:
            p = 0
            while p < len(payload):
                if payload[p] >> 4:
                    raise StreamError("16-bit quantisation table")
                qt[payload[p] & 15] = np.frombuffer(
                    payload[p + 1:p + 65], np.uint8).astype(np.int64)
                p += 65
        elif m == 0xC4:
            p = 0
            while p < len(payload):
                tc = payload[p]
                huff[tc >> 4, tc & 15], p = _huffman_lut(payload, p + 1)
        elif m == 0xDD:
            ri = int.from_bytes(payload[:2], "big")
        elif m == 0xC0:
            h = int.from_bytes(payload[1:3], "big")
            w = int.from_bytes(payload[3:5], "big")
            nc = payload[5]
            got = [(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                    payload[7 + 3 * i] & 15) for i in range(nc)]
            want = [(c.index + 1, c.h, c.v) for c in geo.components]
            if payload[0] != 8 or (h, w) != (geo.height, geo.width) \
                    or got != want:
                raise StreamError(f"SOF0 {w}x{h} {got}, expected "
                                  f"{geo.width}x{geo.height} {want}")
            comp_q = [payload[8 + 3 * i] for i in range(nc)]
        elif 0xC1 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise StreamError(f"not baseline: SOF{m - 0xC0}")
        elif m == 0xDA:
            ns = payload[0]
            ids = [payload[1 + 2 * i] - 1 for i in range(ns)]
            sel = {payload[1 + 2 * i] - 1: payload[2 + 2 * i]
                   for i in range(ns)}
            end = pos
            while True:
                j = stream.find(b"\xff", end)
                if j < 0 or j + 1 >= len(stream):
                    raise StreamError("scan without end")
                if stream[j + 1] == 0 or 0xD0 <= stream[j + 1] <= 0xD7:
                    end = j + 2
                    continue
                break
            scans.append((tuple(ids), sel, buf[pos:j]))
            pos = j
    # no DRI, or DRI 0, is a stream without restart markers
    if comp_q is None or (ri or 0) != geo.restart_interval:
        raise StreamError(f"restart interval {ri}, expected "
                          f"{geo.restart_interval}")
    if [s[0] for s in scans] != list(geo.scans):
        raise StreamError(f"scans {[s[0] for s in scans]}, expected "
                          f"{list(geo.scans)}")
    try:
        quant = [qt[comp_q[c.index]] for c in geo.components]
        luts = [None] * len(geo.components)
        for ids, sel, _ in scans:
            for i in ids:
                luts[i] = (huff[0, sel[i] >> 4], huff[1, sel[i] & 15])
    except KeyError as e:
        raise StreamError(f"undefined table {e}") from None
    segs = []
    for s, (_, _, body) in enumerate(scans):
        segs += _split_scan(body, int((geo.seg_scan == s).sum()))
    lens = np.array([len(x) for x in segs], np.int64)
    return Parsed(np.concatenate(segs) if segs else np.zeros(0, np.uint8),
                  (np.cumsum(lens) - lens) * 8, lens * 8, quant, luts)


def _dc_values(diff: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(P, n_blocks) DC differences -> DC values: each summed along its
    chain of predictors (``geo.dc_pred``: a component's blocks in scan
    order within a segment, the whole scan without restarts)."""
    dev = diff.device
    seg_of_block = np.repeat(np.arange(geo.n_segments), geo.seg_count)
    order = np.lexsort((np.arange(geo.n_blocks), geo.block_comp,
                        seg_of_block))
    head = geo.dc_pred[order] < 0
    chain = torch.as_tensor(np.cumsum(head) - 1, device=dev)
    order, head = torch.as_tensor(order, device=dev), \
        torch.as_tensor(head, device=dev)
    d = diff[:, order]
    cs = d.cumsum(1)
    out = torch.empty_like(diff)
    # a block's running sum less the sum before its chain's head
    out[:, order] = cs - (cs - d)[:, head][:, chain]
    return out


class _Lanes:
    """The lockstep decoder's constants: the streams' bits, their
    lookups, and for each lane its segment, stream and stop."""

    def __init__(self, parsed: list, geo: Geometry, dev, chunk_bits: int):
        P, S = len(parsed), geo.n_segments
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
        data = np.concatenate([p.data for p in parsed]
                              + [np.zeros(8, np.uint8)])
        base = np.cumsum([0] + [len(p.data) * 8 for p in parsed])[:-1]
        self.n_bytes = len(data)
        self.buf = t(data).to(torch.int64)
        bit0 = t(np.concatenate([p.seg_bit0 + b
                                 for p, b in zip(parsed, base)]))
        self.seg_end = bit0 + t(np.concatenate([p.seg_bits
                                                for p in parsed]))
        self.nc, self.nb = len(geo.components), geo.n_blocks
        # lookups: table (stream, component, class) -> row of ``lut``
        self.lut = t(np.stack([p.luts[c][k] for p in parsed
                               for c in range(self.nc) for k in (0, 1)]))
        self.seg_stream = torch.arange(P * S, device=dev) // S
        self.seg_start = t(geo.seg_start).repeat(P)
        self.seg_count = t(geo.seg_count).repeat(P)
        self.comp_of_block = t(geo.block_comp)
        #: blocks of an MCU: a segment's components repeat with it
        self.bpm = sum(c.h * c.v for c in geo.components) \
            if geo.interleaved else 1
        # a lane a chunk of ``chunk_bits``; the last chunk of a segment
        # starts 8 bits or more before its end, so that the decode of the
        # whole segment passes every chunk's start
        n = torch.ones(P * S, dtype=torch.int64, device=dev)
        if chunk_bits:
            n = (self.seg_end - bit0 - 8).clamp(min=0) // chunk_bits + 1
        self.seg = torch.repeat_interleave(torch.arange(P * S, device=dev),
                                           n)
        j = torch.arange(len(self.seg), device=dev) \
            - (torch.cumsum(n, 0) - n)[self.seg]
        self.first = j == 0
        self.last = j == n[self.seg] - 1
        self.start = bit0[self.seg] + j * chunk_bits
        self.stop = torch.where(self.last, _NEVER, self.start + chunk_bits)

    def run(self, lanes, pos, blk, k, count, out=None) -> tuple:
        """Decode ``lanes`` from (bit, block of the segment, zig-zag
        index; a block's component is that of the block at its place in
        the MCU), a symbol of every live lane a step, until each is at
        block ``count``, reaches a symbol boundary at or past its stop,
        or fails: an invalid code, a coefficient past 63, a bit read past
        its segment. Returns the end (bit, block, index), whether it
        failed, and the steps. With ``out``, (P * n_blocks * 64,), each
        coefficient is written there, a DC as its difference."""
        dev = pos.device
        seg = self.seg[lanes]
        stream, s0 = self.seg_stream[seg], self.seg_start[seg]
        end, stop = self.seg_end[seg], self.stop[lanes]
        bad = torch.zeros_like(pos, dtype=torch.bool)
        live = (blk < count) & (pos < stop)
        shifts = torch.tensor([32, 24, 16, 8, 0], device=dev)
        steps = 0
        while bool(live.any()):
            steps += 1
            comp = self.comp_of_block[s0 + blk % self.bpm]
            byte = (pos >> 3).clamp(max=self.n_bytes - 8)
            win = (self.buf[byte[:, None] + torch.arange(5, device=dev)]
                   << shifts).sum(1)
            win = (win << (pos & 7)) & ((1 << 40) - 1)
            row = (stream * self.nc + comp) * 2 + (k > 0).to(torch.int64)
            e = self.lut[row, win >> 24]
            n, sym = e & 255, e >> 8
            dc = k == 0
            size = torch.where(dc, sym, sym & 15)
            run = torch.where(dc, 0, sym >> 4)
            raw = (win >> (40 - n - size).clamp(min=0)) & ((1 << size) - 1)
            val = torch.where(
                (size > 0) & (raw < (1 << (size - 1).clamp(min=0))),
                raw - (1 << size) + 1, raw)
            fail = live & ((n == 0) | (size > 11))
            eob = ~dc & (sym == 0)
            zrl = ~dc & (sym == 0xF0)
            at = torch.where(dc, 0, k + run)
            write = live & ~fail & ~eob & ~zrl & (at < 64)
            fail = fail | (live & ~dc & ~eob & ~zrl & (at >= 64))
            fail = fail | (live & zrl & (k + 16 > 64))
            if out is not None:
                idx = ((stream * self.nb + s0 + blk) * 64
                       + at.clamp(max=63))[write]
                out[idx] = val[write]
            k = torch.where(live, torch.where(eob, 64, torch.where(
                zrl, k + 16, at + 1)), k)
            pos = torch.where(live, pos + n + size, pos)
            fail = fail | (live & (pos > end))
            done = live & (k >= 64)
            blk = blk + done.to(torch.int64)
            k = torch.where(done, 0, k)
            bad = bad | fail
            live = live & ~fail & (blk < count) & (pos < stop)
        return pos, blk, k, bad, steps


def _any(seg: torch.Tensor, flag: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: whether ``flag`` holds for any lane of each segment."""
    return torch.zeros(n, dtype=torch.int64, device=flag.device) \
        .index_add_(0, seg, flag.to(torch.int64)) > 0


def _segmented_exclusive(x: torch.Tensor, first: torch.Tensor
                         ) -> torch.Tensor:
    """Sum of ``x`` over the earlier lanes of each lane's segment (lanes of
    a segment are consecutive, ``first`` marks each segment's first)."""
    before = torch.cumsum(x, 0) - x
    head = torch.cummax(torch.where(first, torch.arange(
        len(x), device=x.device), 0), 0).values
    return before - before[head]


def decode_segments(parsed: list, geo: Geometry, device,
                    chunk_bits: int | None = None) -> tuple:
    """Huffman-decode the segments of several parsed streams of one
    geometry at once, a symbol of every lane a step. Returns the
    (n_streams, n_blocks, 64) int32 zig-zag coefficients, scan order, a
    (n_streams, n_segments) bool of the segments that decoded whole
    (every block, no invalid code, no bit read past the segment and at
    most 7 bits of padding left; the blocks of the others are 0), and the
    decode's counts: lanes, rounds and steps.

    A lane is a segment, or, where ``chunk_bits`` is set (by default
    :data:`CHUNK_BITS` at restart interval 0, where a segment is a whole
    scan; none otherwise), a chunk of that many bits of one. Each chunk's
    lane runs from a start (bit, block, zig-zag index) to the first
    symbol boundary at or past the next chunk's start, and that end is
    the next lane's start in the next round: first a guess (the chunk's
    first bit, a block's DC), then its predecessor's end, until no start
    changes. A segment's first lane starts exact, so each round settles
    at least one more lane; the code's self-synchronisation settles most
    in the first rounds. The blocks of each lane's segment before it are
    then counted, and a last pass decodes every lane from its settled
    start, its last lane up to the segment's last block.
    """
    dev = torch.device(device)
    P, S = len(parsed), geo.n_segments
    if chunk_bits is None:
        chunk_bits = CHUNK_BITS if geo.restart_interval == 0 else 0
    ln = _Lanes(parsed, geo, dev, chunk_bits)
    L, last = len(ln.seg), ln.last
    # each lane's start (bit, block of its MCU, zig-zag index); its last
    # run's end, failure and blocks; the segments that failed
    pos, phase, k = ln.start.clone(), torch.zeros_like(ln.start), \
        torch.zeros_like(ln.start)
    e_pos, e_phase, e_k, dblk = pos.clone(), phase.clone(), k.clone(), \
        torch.zeros_like(pos)
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    failed = torch.zeros(P * S, dtype=torch.bool, device=dev)
    counts = {"lanes": L, "rounds": 0, "steps": 0}
    prev = (torch.arange(L, device=dev) - 1).clamp(min=0)
    todo = ~last
    while bool(todo.any()):
        i = torch.nonzero(todo)[:, 0]
        e_pos[i], e_blk, e_k[i], bad[i], n = ln.run(
            i, pos[i], phase[i], k[i], torch.full_like(i, _NEVER))
        e_phase[i], dblk[i] = e_blk % ln.bpm, e_blk - phase[i]
        counts["rounds"] += 1
        counts["steps"] += n
        # a lane's end is its successor's next start, unless it failed
        take = ~ln.first & ~bad[prev]
        n_pos = torch.where(take, e_pos[prev], pos)
        n_phase = torch.where(take, e_phase[prev], phase)
        n_k = torch.where(take, e_k[prev], k)
        moved = (n_pos != pos) | (n_phase != phase) | (n_k != k)
        # a lane ran from its exact start where no lane before it in its
        # segment failed or saw its successor's start move
        brk = ~last & (bad | torch.cat([moved[1:], moved[:1]]))
        clean = _segmented_exclusive(brk.to(torch.int64), ln.first) == 0
        failed |= _any(ln.seg, clean & bad, P * S)
        unsettled = _any(ln.seg, brk, P * S) & ~failed
        pos, phase, k = n_pos, n_phase, n_k
        todo = moved & ~last & unsettled[ln.seg]
    # the last pass: each lane from its settled start, its blocks counted
    # from its segment's lanes before it
    out = torch.zeros(P * ln.nb * 64, dtype=torch.int64, device=dev)
    blk0 = _segmented_exclusive(torch.where(last, 0, dblk), ln.first)
    i = torch.nonzero(~failed[ln.seg])[:, 0]
    seg = ln.seg[i]
    f_pos, f_blk, _, f_bad, n = ln.run(i, pos[i], blk0[i], k[i],
                                       ln.seg_count[seg], out)
    counts["steps"] += n
    # a segment fails where a lane fails, where its blocks end before a
    # lane's stop (more than 7 bits before the segment's end), or where
    # more than 7 bits are left after its last block
    wrong = f_bad | (~last[i] & (f_blk >= ln.seg_count[seg])
                     & (f_pos < ln.stop[i])) \
        | (last[i] & (ln.seg_end[seg] - f_pos >= 8))
    failed |= _any(seg, wrong, P * S)
    ok = ~failed.reshape(P, S)
    coeff = out.reshape(P, ln.nb, 64)
    coeff[:, :, 0] = _dc_values(coeff[:, :, 0], geo)
    # the blocks of a segment that failed read as 0
    seg_of_block = torch.repeat_interleave(
        torch.arange(S, device=dev), torch.as_tensor(geo.seg_count,
                                                     device=dev))
    good = ok[:, seg_of_block]
    return (torch.where(good[:, :, None], coeff, 0).to(torch.int32), ok,
            counts)
