"""A plain sequential decoder of baseline scans without restart markers
(T.81 F.2.2), the reference that the lane route of the port's decode is
held to: it reads the stream's own SOF0, DHT and SOS, builds HUFFSIZE,
HUFFCODE, MAXCODE, MINCODE and VALPTR from each DHT (C.1, C.2, F.15),
decodes each scan's blocks one symbol at a time (DECODE F.16, RECEIVE and
EXTEND F.12, the DC predictor of each component across the whole scan,
F.2.2.1) and returns the zig-zag coefficients of every block in the order
the scans give them, DC values and not differences.

Plain Python and PyTorch: it imports nothing of ``gpujpeg_tpu_torch`` and
nothing of JAX."""
from __future__ import annotations

import torch


class StreamError(ValueError):
    pass


def _segments(data: bytes):
    """(marker, payload, entropy bytes after it) of each marker segment,
    in stream order; the entropy bytes follow an SOS only."""
    if data[:2] != b"\xff\xd8":
        raise StreamError("no SOI")
    i, out = 2, []
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise StreamError(f"no marker at {i}")
        m = data[i + 1]
        if m == 0xD9:
            break
        n = int.from_bytes(data[i + 2:i + 4], "big")
        payload = data[i + 4:i + 2 + n]
        i += 2 + n
        body = b""
        if m == 0xDA:       # the entropy bytes: up to a marker that is not
            j = i           # a stuffed zero or a restart marker
            while j + 1 < len(data) and not (
                    data[j] == 0xFF and data[j + 1] != 0
                    and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
            body, i = data[i:j], j
        out.append((m, payload, body))
    return out


class Huffman:
    """One DHT table's T.81 decoding procedure (C.1, C.2, F.15, F.16)."""

    def __init__(self, bits: list, vals: list):
        size = [l + 1 for l in range(16) for _ in range(bits[l])]  # HUFFSIZE
        code, k, si, huffcode = 0, 0, size[0] if size else 0, []
        while k < len(size):                                     # HUFFCODE
            while k < len(size) and size[k] == si:
                huffcode.append(code)
                code += 1
                k += 1
            code <<= 1
            si += 1
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        j = 0
        for l in range(1, 17):                                   # F.15
            if bits[l - 1] == 0:
                continue
            self.valptr[l] = j
            self.mincode[l] = huffcode[j]
            j += bits[l - 1]
            self.maxcode[l] = huffcode[j - 1]
        self.vals = vals

    def decode(self, r: "BitReader") -> int:
        code, l = r.bit(), 1
        while l <= 16 and code > self.maxcode[l]:
            code = (code << 1) | r.bit()
            l += 1
        if l > 16:
            raise StreamError("invalid Huffman code")
        return self.vals[self.valptr[l] + code - self.mincode[l]]


class BitReader:
    """The entropy bytes MSB first, a stuffed zero after each 0xFF
    dropped; zeros past the end."""

    def __init__(self, body: bytes):
        self.data = body.replace(b"\xff\x00", b"\xff")
        self.pos = 0

    def bit(self) -> int:
        i = self.pos >> 3
        b = self.data[i] if i < len(self.data) else 0
        v = (b >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return v

    def receive(self, s: int) -> int:
        v = 0
        for _ in range(s):
            v = (v << 1) | self.bit()
        return v


def extend(v: int, t: int) -> int:
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


def _block(r: BitReader, dc: Huffman, ac: Huffman, pred: int) -> list:
    zz = [0] * 64
    t = dc.decode(r)
    zz[0] = pred + extend(r.receive(t), t)
    k = 1
    while k < 64:
        rs = ac.decode(r)
        run, s = rs >> 4, rs & 15
        if s == 0:
            if run != 15:
                break       # EOB
            k += 16         # ZRL
            continue
        k += run
        if k > 63:
            raise StreamError("coefficient past 63")
        zz[k] = extend(r.receive(s), s)
        k += 1
    return zz


def decode(data: bytes) -> torch.Tensor:
    """The (n_blocks, 64) int32 zig-zag coefficients of every scan of a
    baseline stream without restart markers, block by block in the order
    each scan codes them, the scans in stream order."""
    tables, comps, frame, blocks = {}, {}, None, []
    for m, p, body in _segments(data):
        if m == 0xDD and int.from_bytes(p[:2], "big"):
            raise StreamError("restart markers")
        if m == 0xC4:
            i = 0
            while i < len(p):
                tc_th, bits = p[i], list(p[i + 1:i + 17])
                vals = list(p[i + 17:i + 17 + sum(bits)])
                tables[tc_th >> 4, tc_th & 15] = Huffman(bits, vals)
                i += 17 + sum(bits)
        elif m == 0xC0:
            H, W = int.from_bytes(p[1:3], "big"), int.from_bytes(p[3:5], "big")
            for c in range(p[5]):
                cid, hv = p[6 + 3 * c], p[7 + 3 * c]
                comps[cid] = (hv >> 4, hv & 15)
            frame = (W, H, max(h for h, _ in comps.values()),
                     max(v for _, v in comps.values()))
        elif m == 0xDA:
            W, H, hmax, vmax = frame
            sel = [(p[1 + 2 * i], p[2 + 2 * i]) for i in range(p[0])]
            r = BitReader(body)
            pred = dict.fromkeys(range(len(sel)), 0)
            if len(sel) == 1:       # A.2.2: the component's own blocks
                h, v = comps[sel[0][0]]
                cw, ch = -(-W * h // hmax), -(-H * v // vmax)
                units = [[0]] * (-(-cw // 8) * -(-ch // 8))
            else:                   # A.2.3: MCUs of every component
                n = -(-W // (8 * hmax)) * -(-H // (8 * vmax))
                mcu = [i for i, (cid, _) in enumerate(sel)
                       for _ in range(comps[cid][0] * comps[cid][1])]
                units = [mcu] * n
            for unit in units:
                for i in unit:
                    td_ta = sel[i][1]
                    zz = _block(r, tables[0, td_ta >> 4],
                                tables[1, td_ta & 15], pred[i])
                    pred[i] = zz[0]
                    blocks.append(zz)
    return torch.tensor(blocks, dtype=torch.int32).reshape(-1, 64)
