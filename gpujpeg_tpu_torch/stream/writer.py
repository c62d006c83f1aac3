"""JPEG stream serializer (host side).

Behavioral parity with the reference writer (reference: src/gpujpeg_writer.c):
header selection by internal color space (JFIF/SPIFF/Adobe), DQT/SOF0/DHT/DRI
emission, COM creator tag, scan headers with optional APP13 segment-info
back-patching (gpujpeg_writer.c:436-636).
"""
from __future__ import annotations

import enum

import numpy as np

from ..plan import CoderPlan
from ..tables import HuffmanTable
from ..types import ColorSpace, ComponentType, HuffmanType
from .markers import (
    APP14_ADOBE_MARKER_LEN,
    Marker,
    MARKER_SEGMENT_INFO,
    SPIFF_COMPRESSION_JPEG,
    SPIFF_CS_BT601_FULL,
    SPIFF_CS_BT601_LIMITED,
    SPIFF_CS_BT709,
    SPIFF_CS_GRAY,
    SPIFF_CS_NONE,
    SPIFF_CS_RGB,
    SPIFF_ENTRY_TAG_EOD,
    SPIFF_ENTRY_TAG_EOD_LENGTH,
    SPIFF_MARKER_LEN,
    SPIFF_VERSION,
)

#: Max payload of one APP marker (64 KiB length field)
MAX_HEADER_SIZE = 65536 - 100


class HeaderType(enum.IntEnum):
    """(reference: gpujpeg_encoder.h header_type)"""

    DEFAULT = 0
    JFIF = 1
    SPIFF = 2
    ADOBE = 3


class JpegWriter:
    """Accumulates the output JPEG byte stream."""

    def __init__(self) -> None:
        self.buf = bytearray()
        # APP13 segment-info back-patch state
        # (reference: gpujpeg_writer.c:500-526)
        self._seginfo_slices: list[tuple[int, int]] = []  # (start, len) in buf
        self._seginfo_index = 0
        self._seginfo_position = 0

    # --- low-level emitters (reference: gpujpeg_writer.h:99-137) ---
    def emit_byte(self, b: int) -> None:
        self.buf.append(b & 0xFF)

    def emit_2byte(self, v: int) -> None:
        self.buf += bytes(((v >> 8) & 0xFF, v & 0xFF))

    def emit_4byte(self, v: int) -> None:
        self.buf += bytes(((v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))

    def emit_marker(self, marker: Marker) -> None:
        self.buf += bytes((0xFF, int(marker)))

    def emit_bytes(self, data: bytes | bytearray | memoryview | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self.buf += data

    # --- markers ---
    def write_soi(self) -> None:
        self.emit_marker(Marker.SOI)

    def write_eoi(self) -> None:
        self.emit_marker(Marker.EOI)

    def write_app0(self) -> None:
        """JFIF APP0 (reference: gpujpeg_writer.c:112-148)."""
        self.emit_marker(Marker.APP0)
        self.emit_2byte(16)
        self.emit_bytes(b"JFIF\x00")
        self.emit_byte(1)  # version major
        self.emit_byte(1)  # version minor
        self.emit_byte(1)  # units: dots per inch
        self.emit_2byte(300)
        self.emit_2byte(300)
        self.emit_byte(0)  # no thumbnail
        self.emit_byte(0)

    def write_app14(self) -> None:
        """Adobe APP14, used for RGB-in-JPEG
        (reference: gpujpeg_writer.c:239-257)."""
        self.emit_marker(Marker.APP14)
        self.emit_2byte(APP14_ADOBE_MARKER_LEN)
        self.emit_bytes(b"Adobe")
        self.emit_2byte(100)  # version
        self.emit_2byte(0)    # flags0
        self.emit_2byte(0)    # flags1
        self.emit_byte(0)     # color transform: 0 = RGB

    def write_spiff(self, plan: CoderPlan) -> None:
        """SPIFF header + EOD directory + second SOI
        (reference: gpujpeg_writer.c:163-229)."""
        comp_count = plan.image.comp_count
        if comp_count == 1:
            cs = SPIFF_CS_GRAY
        else:
            cs = {
                ColorSpace.YCBCR_BT709: SPIFF_CS_BT709,
                ColorSpace.YCBCR_BT601_256LVLS: SPIFF_CS_BT601_FULL,
                ColorSpace.YCBCR_BT601: SPIFF_CS_BT601_LIMITED,
                ColorSpace.RGB: SPIFF_CS_RGB,
            }.get(plan.params.color_space_internal, SPIFF_CS_NONE)
        profile = 1 if cs in (SPIFF_CS_BT601_FULL, SPIFF_CS_GRAY) else 0
        self.emit_marker(Marker.APP8)
        self.emit_2byte(SPIFF_MARKER_LEN)
        self.emit_bytes(b"SPIFF\x00")
        self.emit_2byte(SPIFF_VERSION)
        self.emit_byte(profile)
        self.emit_byte(comp_count)
        self.emit_4byte(plan.image.height)
        self.emit_4byte(plan.image.width)
        self.emit_byte(cs)
        self.emit_byte(8)  # bits per sample
        self.emit_byte(SPIFF_COMPRESSION_JPEG)
        self.emit_byte(0)  # resolution units
        self.emit_4byte(1)
        self.emit_4byte(1)
        # EOD directory entry (must be last; includes following SOI in length)
        self.emit_marker(Marker.APP8)
        self.emit_2byte(SPIFF_ENTRY_TAG_EOD_LENGTH)
        self.emit_4byte(SPIFF_ENTRY_TAG_EOD)
        self.write_soi()

    def write_dqt(self, table_index: int, table_zz: np.ndarray) -> None:
        """(reference: gpujpeg_writer.c:266-285)"""
        self.emit_marker(Marker.DQT)
        self.emit_2byte(67)
        self.emit_byte(table_index)
        self.emit_bytes(np.asarray(table_zz, dtype=np.uint8))

    @staticmethod
    def component_id(index: int, color_space_internal: ColorSpace) -> int:
        """(reference: gpujpeg_writer.c:287-296)"""
        if color_space_internal == ColorSpace.RGB:
            return b"RGBA"[index]
        return index + 1

    def write_sof0(self, plan: CoderPlan) -> None:
        """(reference: gpujpeg_writer.c:304-340)"""
        self.emit_marker(Marker.SOF0)
        comp_count = plan.image.comp_count
        self.emit_2byte(8 + 3 * comp_count)
        self.emit_byte(8)  # precision
        self.emit_2byte(plan.image.height)
        self.emit_2byte(plan.image.width)
        self.emit_byte(comp_count)
        for c in plan.components:
            self.emit_byte(self.component_id(c.index, plan.params.color_space_internal))
            self.emit_byte((c.sampling.horizontal << 4) | c.sampling.vertical)
            self.emit_byte(c.quant_table_index)

    def write_dht(self, comp_type: ComponentType, huff_type: HuffmanType,
                  table: HuffmanTable) -> None:
        """(reference: gpujpeg_writer.c:350-390)"""
        index = int(comp_type)
        if huff_type == HuffmanType.AC:
            index += 16
        self.emit_marker(Marker.DHT)
        n = int(table.bits.sum())
        self.emit_2byte(n + 2 + 1 + 16)
        self.emit_byte(index)
        self.emit_bytes(table.bits)
        self.emit_bytes(table.values[:n])

    def write_dri(self, restart_interval: int) -> None:
        """(reference: gpujpeg_writer.c:398-408)"""
        self.emit_marker(Marker.DRI)
        self.emit_2byte(4)
        self.emit_2byte(restart_interval)

    def write_com(self, text: str) -> None:
        """COM with terminating NUL included
        (reference: gpujpeg_writer.c:410-422)."""
        data = text.encode("ascii") + b"\x00"
        self.emit_marker(Marker.COM)
        self.emit_2byte(2 + len(data))
        self.emit_bytes(data)

    def write_header(self, plan: CoderPlan, quant_tables_zz: dict[int, np.ndarray],
                     huffman_tables: dict[tuple[ComponentType, HuffmanType], HuffmanTable],
                     header_type: HeaderType = HeaderType.DEFAULT) -> None:
        """Emit everything up to (but excluding) the first scan header
        (reference: gpujpeg_writer_write_header, gpujpeg_writer.c:436-497)."""
        self.write_soi()
        cs = plan.params.color_space_internal
        if header_type == HeaderType.DEFAULT:
            if plan.image.comp_count == 4:
                self.write_spiff(plan)
            elif cs in (ColorSpace.YCBCR_BT601, ColorSpace.YCBCR_BT709):
                self.write_spiff(plan)
            elif cs == ColorSpace.RGB:
                self.write_app14()
            else:
                self.write_app0()
        elif header_type == HeaderType.JFIF:
            self.write_app0()
        elif header_type == HeaderType.SPIFF:
            self.write_spiff(plan)
        elif header_type == HeaderType.ADOBE:
            self.write_app14()

        emitted = set()
        for c in plan.components:
            if c.quant_table_index not in emitted:
                self.write_dqt(c.quant_table_index, quant_tables_zz[c.quant_table_index])
                emitted.add(c.quant_table_index)

        self.write_sof0(plan)

        emitted = set()
        for c in plan.components:
            if c.comp_type not in emitted:
                self.write_dht(c.comp_type, HuffmanType.DC,
                               huffman_tables[(c.comp_type, HuffmanType.DC)])
                self.write_dht(c.comp_type, HuffmanType.AC,
                               huffman_tables[(c.comp_type, HuffmanType.AC)])
                emitted.add(c.comp_type)

        self.write_dri(plan.params.restart_interval)
        quality = min(max(plan.params.quality, 1), 100)
        self.write_com(f"CREATOR: GPUJPEG, quality = {quality}")
        if cs == ColorSpace.YCBCR_BT601:
            self.write_com("CS=ITU601")

    # --- scan headers & segment info ---
    def write_scan_header(self, plan: CoderPlan, scan_index: int) -> None:
        """SOS plus optional APP13 segment-info reservation
        (reference: gpujpeg_writer.c:528-636)."""
        scan = plan.scans[scan_index]
        if plan.params.segment_info and plan.params.restart_interval > 0:
            data_size = (scan.segment_count + 1) * 4
            self._seginfo_slices = []
            self._seginfo_index = 0
            self._seginfo_position = 0
            while data_size > 0:
                header_size = min(data_size, MAX_HEADER_SIZE)
                data_size -= header_size
                self.emit_marker(MARKER_SEGMENT_INFO)
                self.emit_2byte(3 + header_size)
                self.emit_byte(scan_index)
                start = len(self.buf)
                self.buf += bytes(header_size)
                self._seginfo_slices.append((start, header_size))

        self.emit_marker(Marker.SOS)
        cs = plan.params.color_space_internal
        if plan.params.interleaved and plan.image.comp_count > 1:
            comp_count = plan.image.comp_count
            self.emit_2byte(6 + 2 * comp_count)
            self.emit_byte(comp_count)
            for c in plan.components:
                self.emit_byte(self.component_id(c.index, cs))
                self.emit_byte((c.dc_huff_index << 4) | c.ac_huff_index)
        else:
            c = plan.components[scan_index]
            self.emit_2byte(8)
            self.emit_byte(1)
            self.emit_byte(self.component_id(c.index, cs))
            self.emit_byte((c.dc_huff_index << 4) | c.ac_huff_index)
        self.emit_byte(0)     # Ss
        self.emit_byte(0x3F)  # Se
        self.emit_byte(0)     # Ah/Al

    def write_segment_info(self, position: int | None = None) -> None:
        """Record current (or given) position as the next segment boundary
        in the reserved APP13 blocks (reference: gpujpeg_writer.c:500-526)."""
        if not self._seginfo_slices:
            return
        if self._seginfo_position == 0:
            self._seginfo_position = len(self.buf)
        if position is None:
            position = len(self.buf) - self._seginfo_position
        offset = self._seginfo_index * 4
        for start, size in self._seginfo_slices:
            if offset < size:
                self.buf[start + offset:start + offset + 4] = position.to_bytes(4, "big")
                break
            offset -= size
        self._seginfo_index += 1

    def patch_segment_info(self, offsets) -> None:
        """Back-patch all segment boundary positions at once (used when the
        whole scan body was emitted in one shot by the device encoder).
        Vectorized: one big-endian u32 payload written across the reserved
        APP13 slices (a per-offset write_segment_info loop costs ~20 ms at
        8K — 145k Python calls per frame)."""
        if not self._seginfo_slices:
            return
        if self._seginfo_position == 0:
            self._seginfo_position = len(self.buf)
        n = len(offsets)
        payload = np.ascontiguousarray(
            np.asarray(offsets, np.int64).astype(">u4")).tobytes()
        mv = memoryview(payload)
        pos = self._seginfo_index * 4
        for start, size in self._seginfo_slices:
            if not len(mv):
                break
            if pos >= size:
                pos -= size
                continue
            take = min(size - pos, len(mv))
            self.buf[start + pos:start + pos + take] = mv[:take]
            mv = mv[take:]
            pos = 0
        self._seginfo_index += n

    def tobytes(self) -> bytes:
        return bytes(self.buf)


#: the eight restart markers RST0-RST7, in cycle order
RST_MARKERS = tuple(bytes((0xFF, 0xD0 + i)) for i in range(8))


def join_segments(plan: CoderPlan, seg_bytes: list[bytes]):
    """The host coder's per-segment bytes -> (per-scan bodies with RST
    markers between segments, per-scan (n,) int64 segment sizes, each but
    the scan's last counting its marker) (reference stream formatter:
    gpujpeg_encoder.c:479-537)."""
    bodies, sizes_by_scan = [], []
    seg = 0
    for scan in plan.scans:
        n = scan.segment_count
        chunk = seg_bytes[seg:seg + n]
        seg += n
        sizes = np.fromiter(map(len, chunk), np.int64, n)
        sizes[:-1] += 2
        parts = []
        for i, data in enumerate(chunk):
            parts.append(data)
            if i != n - 1:
                parts.append(RST_MARKERS[i & 7])
        bodies.append(b"".join(parts))
        sizes_by_scan.append(sizes)
    return bodies, sizes_by_scan


def scan_bodies(plan: CoderPlan, bands: list):
    """Compacted bands -> (per-scan bodies, per-scan (n,) int64 segment
    sizes). ``bands`` holds each band's (its segments' bytes back to back,
    RST markers in place, as a uint8 array; (S,) per-segment byte counts)
    in band order, each band coded on ``plan`` (the frame itself is the
    one band); a scan's body is its segments of every band in turn, one
    copy of its bytes."""
    bodies, sizes_by_scan = [], []
    pos = [0] * len(bands)
    seg = 0
    for scan in plan.scans:
        n = scan.segment_count
        sizes = np.concatenate([lens[seg:seg + n] for _, lens in bands],
                               dtype=np.int64)
        parts = []
        for k, (flat, _) in enumerate(bands):
            end = pos[k] + int(sizes[k * n:(k + 1) * n].sum())
            parts.append(flat[pos[k]:end])
            pos[k] = end
        bodies.append(b"".join(parts))
        sizes_by_scan.append(sizes)
        seg += n
    return bodies, sizes_by_scan


def assemble(plan: CoderPlan, quant_zz: dict, huff: dict, bodies,
             seg_sizes, header_type: HeaderType = HeaderType.DEFAULT
             ) -> bytes:
    """The JPEG stream of ``plan`` from its per-scan bodies, RST markers in
    place, and per-scan segment sizes (:func:`scan_bodies`,
    :func:`join_segments`): the header, each scan's header and body with
    APP13 segment info back-patched, EOI (reference:
    gpujpeg_encoder.c:479-537)."""
    w = JpegWriter()
    w.write_header(plan, quant_zz, huff, header_type)
    for scan in plan.scans:
        w.write_scan_header(plan, scan.index)
        w.emit_bytes(bodies[scan.index])
        sizes = seg_sizes[scan.index]
        w.patch_segment_info(np.concatenate([[0], np.cumsum(sizes)]))
    w.write_eoi()
    return w.tobytes()
