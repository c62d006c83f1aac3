"""JPEG stream parser (host side).

The behavioral analog of the reference reader (reference:
src/gpujpeg_reader.c): SOI/APPn/COM/DQT/SOF0/DHT/DRI/SOS marker parsing,
color-space deduction from JFIF/SPIFF/Adobe/COM markers and component IDs,
and scan-body splitting into restart segments — either byte-scan
(gpujpeg_reader.c:930-1046) or O(1) via GPUJPEG's APP13 segment-info
extension (gpujpeg_reader.c:1058-1126).

The byte scan is vectorized with NumPy instead of a per-byte C loop: all
0xFF positions are classified at once, which is the same work the
reference's ``memchr`` loop does but in O(#FF-bytes) array ops.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..tables import dht_huffman_table, HuffmanTable
from ..types import ColorSpace, PixelFormat, SamplingFactor
from .markers import (
    Marker,
    SPIFF_CS_BT601_FULL,
    SPIFF_CS_BT601_LIMITED,
    SPIFF_CS_BT709,
    SPIFF_CS_GRAY,
    SPIFF_CS_RGB,
    marker_name,
)

log = logging.getLogger("gpujpeg_tpu_torch.reader")


@dataclasses.dataclass
class ScanComponent:
    comp_index: int
    dc_table: int
    ac_table: int


@dataclasses.dataclass
class ScanInfo:
    index: int
    components: list[ScanComponent]
    #: raw scan-body view (entropy bytes WITH RST markers still present
    #: between segment ranges)
    data: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.uint8))
    #: per-segment [lo, hi) ranges into ``data`` as an (n, 2) int64
    #: array (kept as an ndarray end-to-end: converting ~50k tuple
    #: pairs per scan costs ~10 ms at 8K); bytes between ranges are RST
    #: markers that consumers must not treat as entropy data
    segments: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))


@dataclasses.dataclass
class ComponentInfo:
    comp_id: int
    sampling: SamplingFactor
    quant_table_index: int


@dataclasses.dataclass
class JpegInfo:
    width: int = 0
    height: int = 0
    comp_count: int = 0
    color_space: ColorSpace = ColorSpace.NONE
    components: list[ComponentInfo] = dataclasses.field(default_factory=list)
    quant_tables: dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    huffman_tables: dict[tuple[int, int], HuffmanTable] = dataclasses.field(default_factory=dict)
    restart_interval: int = 0
    interleaved: bool = False
    scans: list[ScanInfo] = dataclasses.field(default_factory=list)
    comment: str = ""
    have_jfif: bool = False
    have_adobe: bool = False
    have_spiff: bool = False
    segment_info_found: bool = False
    #: the DHT tables this parse derived; the others were shared from
    #: earlier parses (``tables.dht_huffman_table``)
    tables_fresh: int = 0

    @property
    def sampling(self) -> tuple[SamplingFactor, ...]:
        return tuple(c.sampling for c in self.components)

    @property
    def segment_count(self) -> int:
        """Total restart segments: counted from parsed scans when present,
        else derived from geometry + DRI (reference prints this in info
        mode, src/main.c:133-136)."""
        if self.scans and any(len(s.segments) for s in self.scans):
            return sum(len(s.segments) for s in self.scans)
        if not self.width or not self.height or not self.components:
            return 0
        mcu_counts = []
        max_h = max(c.sampling.horizontal for c in self.components)
        max_v = max(c.sampling.vertical for c in self.components)
        if self.interleaved and self.comp_count > 1:
            mcu_counts.append(
                (-(-self.width // (8 * max_h))) * (-(-self.height // (8 * max_v))))
        else:
            for c in self.components:
                cw = -(-self.width * c.sampling.horizontal // max_h)
                ch = -(-self.height * c.sampling.vertical // max_v)
                mcu_counts.append((-(-cw // 8)) * (-(-ch // 8)))
        ri = self.restart_interval
        if ri <= 0:
            return len(mcu_counts)
        return sum(-(-m // ri) for m in mcu_counts)

    def deduce_pixel_format(self) -> PixelFormat:
        """Output pixel format from sampling factors
        (reference: gpujpeg_reader.c:1523-1691)."""
        if self.comp_count == 1:
            return PixelFormat.U8
        if self.comp_count == 4:
            return PixelFormat.PF_444_U8_P012A
        s = [(c.sampling.horizontal, c.sampling.vertical) for c in self.components]
        if s[1] == (1, 1) and s[2] == (1, 1):
            if s[0] == (1, 1):
                return PixelFormat.PF_444_U8_P012
            if s[0] == (2, 1):
                return PixelFormat.PF_422_U8_P1020
            if s[0] == (2, 2):
                return PixelFormat.PF_420_U8_P0P1P2
        return PixelFormat.PF_444_U8_P012


class JpegParseError(Exception):
    pass


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise JpegParseError("unexpected end of data")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self) -> int:
        return (self.byte() << 8) | self.byte()

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise JpegParseError("unexpected end of data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b


def _read_marker(c: _Cursor) -> int:
    b = c.byte()
    if b != 0xFF:
        raise JpegParseError(f"expected marker 0xFF, got 0x{b:02x} at {c.pos - 1}")
    m = c.byte()
    while m == 0xFF:  # fill bytes are legal
        m = c.byte()
    return m


def _parse_app0(info: JpegInfo, payload: bytes) -> None:
    """JFIF (reference: gpujpeg_reader.c:191-322)."""
    if payload[:5] == b"JFIF\x00":
        info.have_jfif = True
        if info.color_space == ColorSpace.NONE:
            info.color_space = ColorSpace.YCBCR_BT601_256LVLS


def _parse_app8(info: JpegInfo, payload: bytes) -> None:
    """SPIFF (reference: gpujpeg_reader.c:381-513)."""
    if payload[:6] != b"SPIFF\x00" or len(payload) < 30:
        return
    info.have_spiff = True
    # layout: SPIFF\0(6) version(2) profile(1) comps(1) h(4) w(4) cs(1) ...
    cs = payload[18]
    mapping = {
        SPIFF_CS_BT709: ColorSpace.YCBCR_BT709,
        SPIFF_CS_BT601_FULL: ColorSpace.YCBCR_BT601_256LVLS,
        SPIFF_CS_BT601_LIMITED: ColorSpace.YCBCR_BT601,
        SPIFF_CS_RGB: ColorSpace.RGB,
        SPIFF_CS_GRAY: ColorSpace.NONE,
    }
    got = mapping.get(cs)
    if got is not None and got != ColorSpace.NONE:
        info.color_space = got


def _parse_app14(info: JpegInfo, payload: bytes) -> None:
    """Adobe (reference: gpujpeg_reader.c:529-605)."""
    if payload[:5] != b"Adobe" or len(payload) < 12:
        return
    info.have_adobe = True
    transform = payload[11]
    if transform == 0:
        info.color_space = ColorSpace.RGB
    elif transform == 1:
        info.color_space = ColorSpace.YCBCR_BT601_256LVLS
    else:
        log.warning("unsupported Adobe color transform %d", transform)


def _parse_com(info: JpegInfo, payload: bytes) -> None:
    """COM CS=ITU601 detection (reference: gpujpeg_reader.c:607-634)."""
    text = payload.rstrip(b"\x00").decode("ascii", errors="replace")
    info.comment = text
    if text == "CS=ITU601":
        info.color_space = ColorSpace.YCBCR_BT601


def _parse_dqt(info: JpegInfo, payload: bytes) -> None:
    """Multi-table DQT with Pq/Tq (reference: gpujpeg_reader.c:643-688)."""
    pos = 0
    while pos < len(payload):
        pq_tq = payload[pos]
        pos += 1
        pq, tq = pq_tq >> 4, pq_tq & 0xF
        if pq not in (0, 1) or tq > 3:
            raise JpegParseError(f"bad DQT Pq/Tq 0x{pq_tq:02x}")
        need = 64 if pq == 0 else 128
        if pos + need > len(payload):
            raise JpegParseError("truncated DQT table")
        if pq == 0:
            table = np.frombuffer(payload[pos:pos + 64], dtype=np.uint8).astype(np.int32)
            pos += 64
        else:
            table = np.frombuffer(payload[pos:pos + 128], dtype=">u2").astype(np.int32)
            pos += 128
        info.quant_tables[tq] = table  # zig-zag order as stored in stream


def _parse_sof0(info: JpegInfo, payload: bytes) -> None:
    """SOF0/SOF1 with component-ID color-space deduction
    (reference: gpujpeg_reader.c:702-807)."""
    if len(payload) < 6:
        raise JpegParseError("truncated SOF0 payload")
    precision = payload[0]
    if precision != 8:
        raise JpegParseError(f"unsupported sample precision {precision}")
    info.height = (payload[1] << 8) | payload[2]
    info.width = (payload[3] << 8) | payload[4]
    info.comp_count = payload[5]
    # 2-component streams are legal T.81 but have no pixel format here
    # or in the reference (1/3/4-component registry, gpujpeg_common.c:105)
    if info.comp_count not in (1, 3, 4):
        raise JpegParseError(
            f"unsupported SOF component count {info.comp_count}")
    if 6 + 3 * info.comp_count > len(payload):
        raise JpegParseError("truncated SOF0 payload")
    pos = 6
    ids = []
    info.components = []
    for _ in range(info.comp_count):
        comp_id = payload[pos]
        samp = payload[pos + 1]
        tq = payload[pos + 2]
        pos += 3
        # T.81 B.2.2: sampling factors are 1..4 (0 would plan empty
        # component planes and crash downstream instead of erroring)
        if not (1 <= samp >> 4 <= 4 and 1 <= (samp & 0xF) <= 4):
            raise JpegParseError(f"bad SOF sampling factor 0x{samp:02x}")
        ids.append(comp_id)
        info.components.append(ComponentInfo(
            comp_id=comp_id,
            sampling=SamplingFactor(samp >> 4, samp & 0xF),
            quant_table_index=tq,
        ))
    # 'R','G','B' component ids mean RGB-in-JPEG (reference: :753-775)
    if ids[:3] == [0x52, 0x47, 0x42]:
        info.color_space = ColorSpace.RGB


def _parse_dht(info: JpegInfo, payload: bytes) -> None:
    """Up to 4 tables per marker (reference: gpujpeg_reader.c:816-878)."""
    pos = 0
    while pos < len(payload):
        tc_th = payload[pos]
        pos += 1
        tc, th = tc_th >> 4, tc_th & 0xF
        if tc > 1 or th > 3:
            raise JpegParseError(f"bad DHT Tc/Th 0x{tc_th:02x}")
        if pos + 16 > len(payload):
            raise JpegParseError("truncated DHT bits array")
        bits = bytes(payload[pos:pos + 16])
        pos += 16
        n = sum(bits)
        # T.81 B.2.4.2: at most 256 values, and they must all be present
        # in the payload (a corrupt count would otherwise trip internal
        # shape checks instead of a parse error)
        if n > 256 or pos + n > len(payload):
            raise JpegParseError(
                f"corrupt DHT: {n} values declared, "
                f"{len(payload) - pos} bytes remain")
        values = bytes(payload[pos:pos + n])
        pos += n
        info.huffman_tables[(tc, th)], fresh = dht_huffman_table(bits, values)
        info.tables_fresh += fresh


def _parse_dri(info: JpegInfo, payload: bytes) -> None:
    """(reference: gpujpeg_reader.c:888-918)"""
    if len(payload) < 2:
        raise JpegParseError("truncated DRI payload")
    value = (payload[0] << 8) | payload[1]
    if info.restart_interval and value != info.restart_interval:
        # reference errors on redefinition; we accept the last value but warn
        log.warning("DRI redefinition %d -> %d", info.restart_interval, value)
    info.restart_interval = value


_RST_SET = frozenset(range(0xD0, 0xD8))


def _split_scan(data: bytes, start: int) -> tuple[np.ndarray, list[tuple[int, int]], int]:
    """Split a scan body into restart segments.

    Returns (raw scan-body view, per-segment [lo, hi) byte ranges into
    that view, file position just after the scan body). Segments are
    zero-copy ranges: the bytes *between* ranges are the RST markers,
    which consumers must not treat as entropy data. Vectorized
    equivalent of the reference's memchr loop, including RST-sequence
    validation with forward resynchronization on mismatch
    (reference: gpujpeg_reader.c:930-1046, resync :962-996).
    """
    buf = np.frombuffer(data, dtype=np.uint8, offset=start)

    native = _split_scan_native(data, start, buf)
    if native is not None:
        return native

    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    is_stuff = nxt == 0x00
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    is_term = ~is_stuff & ~is_rst
    term_idx = np.flatnonzero(is_term)
    if term_idx.size == 0:
        raise JpegParseError("scan not terminated by a marker")
    end = int(ff[term_idx[0]])  # offset of the terminating 0xFF

    in_scan = (ff < end) & is_rst
    rst_pos = ff[in_scan]
    rst_mark = (nxt[in_scan].astype(np.int64) - 0xD0)

    if np.array_equal(rst_mark, np.arange(rst_mark.size) % 8):
        # common case: RST(n mod 8) sequence intact — pure array math
        bounds = np.concatenate([[0], rst_pos + 2, [end]])
        seg_starts = bounds[:-1].copy()
        seg_ends = np.concatenate([rst_pos, [end]])
    else:
        seg_starts, seg_ends = _resync_rst_sequence(
            rst_pos, rst_mark, end)

    # drop empty segments (FFmpeg bug #8412 workaround,
    # reference: gpujpeg_reader.c:1022-1025)
    nonempty = seg_ends > seg_starts
    seg_starts, seg_ends = seg_starts[nonempty], seg_ends[nonempty]

    # zero-copy: segment ranges index straight into the scan body view
    # (the RST bytes simply lie between ranges — every consumer slices
    # [lo:hi], so no concatenation pass over 50k segments is needed)
    segments = np.stack([seg_starts, seg_ends], axis=1)
    return buf[:end], segments, start + end


def _split_scan_native(data: bytes, start: int, buf: np.ndarray):
    """Fast path: C++ memchr scan splitter (native/host_codec.cpp
    gj_scan_split). Returns None when the native library is unavailable
    or the RST sequence needs the recovery walk (empty segments also
    route to the NumPy path so sequence validation stays exact)."""
    from ..native import lib
    import ctypes
    L = lib()
    if L is None:
        return None
    arr = buf if buf.flags.c_contiguous else np.ascontiguousarray(buf)
    max_segs = arr.size // 2 + 2
    seg_starts = np.empty(max_segs, np.int64)
    seg_ends = np.empty(max_segs, np.int64)
    scan_end = ctypes.c_int64(0)
    n = L.gj_scan_split(arr, arr.size, 0, seg_starts, seg_ends, max_segs,
                        ctypes.byref(scan_end))
    if n < 0:
        raise JpegParseError("scan not terminated by a marker")
    end = int(scan_end.value)
    seg_starts, seg_ends = seg_starts[:n], seg_ends[:n]
    # validate RST(n mod 8) ordering; the markers sit right after each
    # non-final segment's end. Any mismatch (or dropped empty segment,
    # which offsets the sequence) falls back to the recovery walk.
    if n > 1:
        marks = buf[seg_ends[:-1] + 1].astype(np.int64) - 0xD0
        if not np.array_equal(marks, np.arange(n - 1) % 8):
            return None
    segments = np.stack([seg_starts, seg_ends], axis=1)
    return buf[:end], segments, start + end


def _resync_rst_sequence(rst_pos: np.ndarray, rst_mark: np.ndarray,
                         end: int) -> tuple[np.ndarray, np.ndarray]:
    """Recovery walk over an out-of-order RST marker list, matching the
    reference's semantics (gpujpeg_reader.c:962-996): on an unexpected
    RST, the current segment still ends at that marker, the data up to
    (and including) the next occurrence of the *expected* marker is
    discarded, and the next segment starts after it. If the expected
    marker never appears, the mismatched RST is ignored (not a segment
    boundary)."""
    seg_starts: list[int] = []
    seg_ends: list[int] = []
    expected = 0
    seg_start = 0
    i = 0
    n = rst_mark.size
    while i < n:
        p = int(rst_pos[i])
        m = int(rst_mark[i])
        if m == expected:
            seg_starts.append(seg_start)
            seg_ends.append(p)
            seg_start = p + 2
            expected = (expected + 1) & 7
            i += 1
            continue
        log.error("expected RST%d but RST%d was presented", expected, m)
        # scan forward for the expected marker
        j = i + 1
        while j < n and int(rst_mark[j]) != expected:
            j += 1
        if j == n:
            log.error("no RST%d found until end of current scan", expected)
            i += 1  # ignore this RST; segment continues
            continue
        q = int(rst_pos[j])
        log.warning("skipping %d bytes of data until RST%d was found",
                    q - p, expected)
        seg_starts.append(seg_start)
        seg_ends.append(p)       # segment ends at the mismatched marker
        seg_start = q + 2        # skipped span is discarded
        expected = (expected + 1) & 7
        i = j + 1
    seg_starts.append(seg_start)
    seg_ends.append(end)
    return np.asarray(seg_starts, np.int64), np.asarray(seg_ends, np.int64)


def read_image(data: bytes) -> JpegInfo:
    """Parse a whole JPEG stream (reference: gpujpeg_reader_read_image,
    gpujpeg_reader.c:1392-1505)."""
    info = JpegInfo()
    c = _Cursor(data)
    if _read_marker(c) != Marker.SOI:
        raise JpegParseError("missing SOI")

    seginfo_payloads: list[bytes] = []
    while True:
        m = _read_marker(c)
        if m == Marker.EOI:
            break
        if m == Marker.SOI:
            continue  # second SOI after SPIFF directory
        if 0xD0 <= m <= 0xD7:
            continue
        length = c.u16()
        payload = c.take(length - 2)

        if m == Marker.APP0:
            _parse_app0(info, payload)
        elif m == Marker.APP8:
            _parse_app8(info, payload)
        elif m == Marker.APP13:
            # GPUJPEG segment info, unless a known Photoshop header
            # (reference: gpujpeg_reader.c:325-378)
            if payload[:14] == b"Photoshop 3.0\x00" or payload[:9] == b"Adobe_CM\x00":
                log.warning("skipping unsupported APP13 header")
            else:
                info.segment_info_found = True
                seginfo_payloads.append(payload)
        elif m == Marker.APP14:
            _parse_app14(info, payload)
        elif m == Marker.COM:
            _parse_com(info, payload)
        elif m == Marker.DQT:
            _parse_dqt(info, payload)
        elif m in (Marker.SOF0, Marker.SOF1):
            _parse_sof0(info, payload)
        elif m in (Marker.SOF2, Marker.SOF3, Marker.SOF5, Marker.SOF6,
                   Marker.SOF7, Marker.SOF9, Marker.SOF10, Marker.SOF11,
                   Marker.SOF13, Marker.SOF14, Marker.SOF15):
            raise JpegParseError(f"unsupported {marker_name(m)} (not baseline)")
        elif m == Marker.DHT:
            _parse_dht(info, payload)
        elif m == Marker.DRI:
            _parse_dri(info, payload)
        elif m == Marker.SOS:
            scan = _parse_sos(info, payload)
            pos = None
            if seginfo_payloads:
                pos = _split_scan_seginfo(info, scan, data, c.pos,
                                          seginfo_payloads)
                seginfo_payloads = []
            if pos is None:   # no/corrupt segment info: byte parse
                scan.data, scan.segments, pos = _split_scan(data, c.pos)
            c.pos = pos
            info.scans.append(scan)
        else:
            pass  # skip unknown APPn etc.

    if info.color_space == ColorSpace.NONE:
        info.color_space = ColorSpace.YCBCR_BT601_256LVLS
    info.interleaved = len(info.scans) == 1 and info.comp_count > 1
    if not info.components or info.width <= 0 or info.height <= 0:
        raise JpegParseError("missing or empty SOF0")
    # every component's quantization table must have been defined by a
    # DQT — consumers index info.quant_tables and must see a parse
    # error for corrupt references, not a KeyError (reference errors
    # in gpujpeg_reader.c's DQT/SOF cross-checks)
    for comp in info.components:
        if comp.quant_table_index not in info.quant_tables:
            raise JpegParseError(
                f"component references undefined quantization table "
                f"{comp.quant_table_index}")
    return info


def _parse_sos(info: JpegInfo, payload: bytes) -> ScanInfo:
    """(reference: gpujpeg_reader.c:1136-1252)"""
    if not payload:
        raise JpegParseError("truncated SOS payload")
    ns = payload[0]
    if ns < 1 or ns > 4 or 1 + 2 * ns > len(payload):
        raise JpegParseError(f"corrupt SOS header (ns={ns}, "
                             f"{len(payload)} bytes)")
    comps = []
    id_to_index = {comp.comp_id: i for i, comp in enumerate(info.components)}
    pos = 1
    for _ in range(ns):
        cs = payload[pos]
        tables = payload[pos + 1]
        pos += 2
        if cs not in id_to_index:
            raise JpegParseError(f"SOS references unknown component id {cs}")
        comps.append(ScanComponent(
            comp_index=id_to_index[cs],
            dc_table=tables >> 4,
            ac_table=tables & 0xF,
        ))
    return ScanInfo(index=len(info.scans), components=comps)


def _split_scan_seginfo(info: JpegInfo, scan: ScanInfo, data: bytes,
                        start: int, payloads: list[bytes]):
    """O(1) segment split using APP13 segment-info offsets
    (reference: gpujpeg_reader.c:1058-1126). Returns None for a corrupt
    segment-info payload (caller falls back to the byte-parse split)."""
    blob = b"".join(p[1:] for p in payloads)  # strip scan_index byte
    if len(blob) < 8 or len(blob) % 4:
        return None
    offsets = np.frombuffer(blob, dtype=">u4").astype(np.int64)
    diffs = np.diff(offsets)
    # every segment but the last ends 2 bytes (the RST marker) before the
    # next offset, so intermediate gaps must be >= 2 or seg_end would land
    # before seg_start; the final segment may be empty (diff == 0)
    if (diffs[:-1] < 2).any() or (diffs.size and diffs[-1] < 0) or \
            start + int(offsets[-1]) > len(data):
        return None
    end = int(offsets[-1])
    buf = np.frombuffer(data, dtype=np.uint8, offset=start)[:end]
    # Segment i spans [offsets[i], offsets[i+1]); every segment but the
    # last is followed by a 2-byte RST marker that we must strip.
    seg_starts = offsets[:-1]
    seg_ends = np.concatenate([offsets[1:-1] - 2, offsets[-1:]])
    # zero-copy ranges into the scan body view (see _split_scan)
    scan.data = buf
    scan.segments = np.stack([seg_starts, seg_ends], axis=1)
    return start + end


def get_image_info(data: bytes) -> JpegInfo:
    """Header-only probe (reference: gpujpeg_reader_get_image_info,
    gpujpeg_reader.c:1523-1691). Parses markers up to the first SOS."""
    info = JpegInfo()
    c = _Cursor(data)
    if _read_marker(c) != Marker.SOI:
        raise JpegParseError("missing SOI")
    while True:
        try:
            m = _read_marker(c)
        except JpegParseError:
            break
        if m in (Marker.EOI, Marker.SOS):
            break
        if m == Marker.SOI or 0xD0 <= m <= 0xD7:
            continue
        length = c.u16()
        payload = c.take(length - 2)
        if m == Marker.APP0:
            _parse_app0(info, payload)
        elif m == Marker.APP8:
            _parse_app8(info, payload)
        elif m == Marker.APP13:
            info.segment_info_found = True
        elif m == Marker.APP14:
            _parse_app14(info, payload)
        elif m == Marker.COM:
            _parse_com(info, payload)
        elif m in (Marker.SOF0, Marker.SOF1):
            _parse_sof0(info, payload)
        elif m == Marker.DRI:
            _parse_dri(info, payload)
    if info.color_space == ColorSpace.NONE:
        info.color_space = ColorSpace.YCBCR_BT601_256LVLS
    return info
