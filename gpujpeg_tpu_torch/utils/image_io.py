"""Image-file delegates: PNM/PAM, Y4M, and headerless raw formats.

Behavioral parity with the reference's pluggable loader/prober/saver
registry (reference: src/utils/image_delegate.c:207-244, src/utils/pam.c,
src/utils/y4m.c, and the raw-extension deduction in
src/gpujpeg_common.c:392-428, 1162-1203).

A copy of the JAX package's ``gpujpeg_tpu/utils/image_io.py`` (pure
NumPy) on the port's ``params`` and ``types``; the port imports nothing
of that package.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import re

import numpy as np

from ..params import ImageParameters
from ..types import ColorSpace, PixelFormat, PIXEL_FORMAT_DESC


class FileFormat(enum.Enum):
    """(reference: enum gpujpeg_image_file_format, gpujpeg_common.h)"""

    UNKNOWN = "unknown"
    RAW = "raw"
    RGB = "rgb"
    RGBA = "rgba"
    RGBZ = "rgbz"
    YUV = "yuv"
    YUVA = "yuva"
    I420 = "i420"
    GRAY = "r"
    JPEG = "jpg"
    PNM = "pnm"
    PGM = "pgm"
    PPM = "ppm"
    PAM = "pam"
    Y4M = "y4m"


_EXT_MAP = {
    "raw": FileFormat.RAW, "rgb": FileFormat.RGB, "rgba": FileFormat.RGBA,
    "rgbz": FileFormat.RGBZ, "yuv": FileFormat.YUV, "yuva": FileFormat.YUVA,
    "i420": FileFormat.I420, "r": FileFormat.GRAY, "gray": FileFormat.GRAY,
    "jpg": FileFormat.JPEG, "jpeg": FileFormat.JPEG, "jfif": FileFormat.JPEG,
    "pnm": FileFormat.PNM, "pgm": FileFormat.PGM, "ppm": FileFormat.PPM,
    "pam": FileFormat.PAM, "y4m": FileFormat.Y4M,
}

#: formats whose samples are YCbCr (reference: adjust_params,
#: src/main.c:186-192: format >= YUV or GRAY -> YCbCr JPEG)
_YCBCR_FORMATS = {FileFormat.YUV, FileFormat.YUVA, FileFormat.I420,
                  FileFormat.GRAY, FileFormat.Y4M}


def image_get_file_format(filename: str) -> FileFormat:
    """(reference: gpujpeg_image_get_file_format, gpujpeg_common.c:392-428)"""
    _, ext = os.path.splitext(filename)
    return _EXT_MAP.get(ext[1:].lower(), FileFormat.UNKNOWN)


# ---------------------------------------------------------------------------
# PNM / PAM (reference: src/utils/pam.c)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PamInfo:
    width: int = 0
    height: int = 0
    depth: int = 0
    maxval: int = 255
    bitmap_pbm: bool = False


def _pnm_read_tokens(data: bytes, pos: int, count: int) -> tuple[list[int], int]:
    """Read ``count`` whitespace-separated integers, skipping '#' comments."""
    vals: list[int] = []
    n = len(data)
    while len(vals) < count:
        while pos < n and data[pos:pos + 1].isspace():
            pos += 1
        if pos < n and data[pos] == ord("#"):
            while pos < n and data[pos] != ord("\n"):
                pos += 1
            continue
        start = pos
        while pos < n and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        vals.append(int(data[start:pos]))
    return vals, pos


def pam_read(data: bytes) -> tuple[np.ndarray, PamInfo]:
    """Parse P4/P5/P6/P7 (reference: pam.c:46-139). Plain ASCII P1-P3 are
    rejected like the reference. P4 bitmaps are expanded to u8 (0/255)."""
    if len(data) < 3 or data[0] != ord("P"):
        raise ValueError("not a PNM/PAM file")
    kind = chr(data[1])
    info = PamInfo()
    if kind in "123":
        raise ValueError(f"plain (ASCII) PNM not supported, input is P{kind}")
    if kind == "7":  # PAM
        m = re.match(rb"P7\n((?:[^\n]*\n)*?)ENDHDR\n", data)
        if not m:
            raise ValueError("truncated PAM header")
        for line in m.group(1).split(b"\n"):
            if not line or line.startswith(b"#"):
                continue
            key, _, val = line.partition(b" ")
            if key == b"WIDTH":
                info.width = int(val)
            elif key == b"HEIGHT":
                info.height = int(val)
            elif key == b"DEPTH":
                info.depth = int(val)
            elif key == b"MAXVAL":
                info.maxval = int(val)
            # TUPLTYPE ignored: DEPTH determines the pixel format
            # (reference: pam.c:70-71)
        pos = m.end()
    elif kind in "456":
        info.depth = {"4": 1, "5": 1, "6": 3}[kind]
        info.bitmap_pbm = kind == "4"
        n_hdr = 2 if kind == "4" else 3
        vals, pos = _pnm_read_tokens(data, 2, n_hdr)
        info.width, info.height = vals[0], vals[1]
        info.maxval = 1 if kind == "4" else vals[2]
        pos += 1  # single whitespace after maxval (reference: check_nl)
    else:
        raise ValueError(f"wrong PNM type P{kind}")
    if info.maxval > 255:
        raise ValueError("16-bit PNM not supported (8-bit samples only)")

    if info.bitmap_pbm:
        row_bytes = (info.width + 7) // 8
        raw = np.frombuffer(data, np.uint8, row_bytes * info.height, pos)
        bits = np.unpackbits(raw.reshape(info.height, row_bytes), axis=1)
        # PBM: 1 = black
        pix = np.where(bits[:, :info.width] > 0, 0, 255).astype(np.uint8)
        return pix.reshape(-1), info
    count = info.width * info.height * info.depth
    pix = np.frombuffer(data, np.uint8, count, pos)
    return pix.copy(), info


def pam_write(info: PamInfo, pixels: np.ndarray, use_pam: bool) -> bytes:
    """(reference: pam.c:204-249)"""
    if use_pam:
        tupl = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
                4: "RGB_ALPHA"}[info.depth]
        hdr = (f"P7\nWIDTH {info.width}\nHEIGHT {info.height}\n"
               f"DEPTH {info.depth}\nMAXVAL {info.maxval}\n"
               f"TUPLTYPE {tupl}\nENDHDR\n")
    else:
        if info.depth not in (1, 3):
            raise ValueError(f"cannot write depth-{info.depth} image as PNM")
        hdr = (f"P{5 if info.depth == 1 else 6}\n"
               f"{info.width} {info.height}\n{info.maxval}\n")
    return hdr.encode("ascii") + np.asarray(pixels, np.uint8).tobytes()


# ---------------------------------------------------------------------------
# Y4M (reference: src/utils/y4m.c)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Y4mInfo:
    width: int = 0
    height: int = 0
    subsampling: int = 420      # 420/422/444, 0 = mono, -1 = 444alpha
    bitdepth: int = 8
    limited: bool = False
    frame_count: int = 0
    header_len: int = 0         # offset of first FRAME marker


Y4M_MONO = 0
Y4M_YUVA = -1


def _y4m_frame_len(info: Y4mInfo) -> int:
    w, h = info.width, info.height
    if info.subsampling == Y4M_MONO:
        n = w * h
    elif info.subsampling == 420:
        n = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2)
    elif info.subsampling == 422:
        n = w * h + 2 * ((w + 1) // 2) * h
    elif info.subsampling == 444:
        n = w * h * 3
    elif info.subsampling == Y4M_YUVA:
        n = w * h * 4
    else:
        raise ValueError(f"unsupported Y4M subsampling {info.subsampling}")
    return n * (2 if info.bitdepth > 8 else 1)


def _y4m_parse_first_line(data: bytes) -> Y4mInfo:
    """Parse the YUV4MPEG2 stream header line only (reference: y4m.c:76-105)."""
    if not data.startswith(b"YUV4MPEG2"):
        raise ValueError("not a Y4M file")
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("truncated Y4M header")
    info = Y4mInfo()
    for item in data[9:nl].split():
        tag, val = chr(item[0]), item[1:].decode("ascii", "replace")
        if tag == "W":
            info.width = int(val)
        elif tag == "H":
            info.height = int(val)
        elif tag == "C":
            if val == "444alpha":
                info.subsampling = Y4M_YUVA
            elif val.startswith("mono"):
                info.subsampling = Y4M_MONO
                if val[4:]:
                    info.bitdepth = int(val[4:])
            else:
                m = re.match(r"(\d+)(?:p(\d+))?", val)
                if not m:
                    raise ValueError(f"Y4M: unable to parse chroma type {val}")
                info.subsampling = int(m.group(1))
                if m.group(2):
                    info.bitdepth = int(m.group(2))
        elif tag == "X" and val == "COLORRANGE=LIMITED":
            info.limited = True
        # F (framerate), I (interlace), A (aspect) ignored like the reference
    if info.bitdepth > 8:
        raise ValueError("only 8-bit Y4M supported")
    info.header_len = nl + 1
    return info


def y4m_parse_header(data: bytes) -> Y4mInfo:
    """Parse the stream header and count frames (reference: y4m.c:76-133)."""
    info = _y4m_parse_first_line(data)
    flen = _y4m_frame_len(info)
    pos = info.header_len
    while pos < len(data) and data[pos:pos + 5] == b"FRAME":
        fnl = data.find(b"\n", pos)
        info.frame_count += 1
        pos = fnl + 1 + flen
    return info


def y4m_read_frames(data: bytes) -> tuple[Y4mInfo, list[np.ndarray]]:
    info = y4m_parse_header(data)
    flen = _y4m_frame_len(info)
    frames = []
    pos = info.header_len
    for _ in range(info.frame_count):
        fnl = data.find(b"\n", pos)
        frames.append(np.frombuffer(data, np.uint8, flen, fnl + 1).copy())
        pos = fnl + 1 + flen
    return info, frames


def y4m_write(info: Y4mInfo, frames: list[np.ndarray]) -> bytes:
    """(reference: y4m.c:135-175)"""
    if info.subsampling == Y4M_MONO:
        chroma = "mono"
    elif info.subsampling == Y4M_YUVA:
        chroma = "444alpha"
    else:
        chroma = str(info.subsampling)
    hdr = f"YUV4MPEG2 W{info.width} H{info.height} F25:1 Ip A1:1 C{chroma}"
    hdr += f" XCOLORRANGE={'LIMITED' if info.limited else 'FULL'}\n"
    out = bytearray(hdr.encode("ascii"))
    for f in frames:
        out += b"FRAME\n"
        out += np.asarray(f, np.uint8).tobytes()
    return bytes(out)


def _y4m_pixel_format(info: Y4mInfo) -> PixelFormat:
    return {
        Y4M_MONO: PixelFormat.U8,
        420: PixelFormat.PF_420_U8_P0P1P2,
        422: PixelFormat.PF_422_U8_P0P1P2,
        444: PixelFormat.PF_444_U8_P0P1P2,
        Y4M_YUVA: PixelFormat.PF_444_U8_P012A,
    }[info.subsampling]


# ---------------------------------------------------------------------------
# Unified probe / load / save (reference: image_delegate.c + gpujpeg_common.c)
# ---------------------------------------------------------------------------

def image_get_properties(filename: str,
                         file_exists: bool = True) -> ImageParameters:
    """Probe a raw-image file: fill width/height/pixel format/color space
    where deducible (reference: gpujpeg_image_get_properties,
    gpujpeg_common.c:1162-1203 + probe delegates)."""
    fmt = image_get_file_format(filename)
    width = height = 0
    pixel_format = PixelFormat.NONE
    color_space = ColorSpace.NONE

    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM, FileFormat.PAM) \
            and file_exists:
        with open(filename, "rb") as f:
            head = f.read(1 << 16)
        # header-only parse (cheap)
        kind = chr(head[1]) if len(head) > 1 else "?"
        if kind == "7":
            m = re.match(rb"P7\n((?:[^\n]*\n)*?)ENDHDR\n", head)
            if m:
                pi = PamInfo()
                for line in m.group(1).split(b"\n"):
                    key, _, val = line.partition(b" ")
                    if key == b"WIDTH":
                        pi.width = int(val)
                    elif key == b"HEIGHT":
                        pi.height = int(val)
                    elif key == b"DEPTH":
                        pi.depth = int(val)
                width, height = pi.width, pi.height
                pixel_format = {1: PixelFormat.U8,
                                3: PixelFormat.PF_444_U8_P012,
                                4: PixelFormat.PF_444_U8_P012A}.get(
                                    pi.depth, PixelFormat.NONE)
        elif kind in "456":
            n_hdr = 2 if kind == "4" else 3
            vals, _ = _pnm_read_tokens(head, 2, n_hdr)
            width, height = vals[0], vals[1]
            pixel_format = (PixelFormat.U8 if kind in "45"
                            else PixelFormat.PF_444_U8_P012)
        color_space = ColorSpace.RGB
    elif fmt == FileFormat.Y4M and file_exists:
        with open(filename, "rb") as f:
            head = f.read(4096)
        info = _y4m_parse_first_line(head)
        width, height = info.width, info.height
        pixel_format = _y4m_pixel_format(info)
        color_space = (ColorSpace.YCBCR_BT601 if info.limited
                       else ColorSpace.YCBCR_BT601_256LVLS)
    else:
        pixel_format = {
            FileFormat.GRAY: PixelFormat.U8,
            FileFormat.RGBA: PixelFormat.PF_444_U8_P012A,
            FileFormat.YUVA: PixelFormat.PF_444_U8_P012A,
            FileFormat.RGBZ: PixelFormat.PF_444_U8_P012Z,
            FileFormat.I420: PixelFormat.PF_420_U8_P0P1P2,
            FileFormat.PGM: PixelFormat.U8,
            FileFormat.PPM: PixelFormat.PF_444_U8_P012,
        }.get(fmt, PixelFormat.PF_444_U8_P012)
        if fmt in _YCBCR_FORMATS:
            color_space = ColorSpace.YCBCR_BT601_256LVLS
        elif fmt in (FileFormat.RGB, FileFormat.RGBA, FileFormat.RGBZ):
            color_space = ColorSpace.RGB

    return ImageParameters(width=width, height=height,
                           color_space=color_space, pixel_format=pixel_format)


def load_image(filename: str) -> tuple[np.ndarray, ImageParameters]:
    """Load a raw image file (reference: gpujpeg_image_load_from_file,
    gpujpeg_common.c:1100-1160). Returns (flat uint8 samples, probed params);
    headerless raw formats return zeroed width/height (caller supplies)."""
    fmt = image_get_file_format(filename)
    with open(filename, "rb") as f:
        data = f.read()

    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM, FileFormat.PAM):
        pix, info = pam_read(data)
        pf = {1: PixelFormat.U8, 3: PixelFormat.PF_444_U8_P012,
              4: PixelFormat.PF_444_U8_P012A}.get(info.depth)
        if pf is None:
            raise ValueError(f"unsupported PNM/PAM depth {info.depth}")
        return pix, ImageParameters(width=info.width, height=info.height,
                                    color_space=ColorSpace.RGB,
                                    pixel_format=pf)
    if fmt == FileFormat.Y4M:
        info, frames = y4m_read_frames(data)
        if not frames:
            raise ValueError("Y4M file contains no frames")
        return frames[0], ImageParameters(
            width=info.width, height=info.height,
            color_space=(ColorSpace.YCBCR_BT601 if info.limited
                         else ColorSpace.YCBCR_BT601_256LVLS),
            pixel_format=_y4m_pixel_format(info))
    # headerless raw
    probed = image_get_properties(filename, file_exists=False)
    return np.frombuffer(data, np.uint8).copy(), probed


def save_image(filename: str, data: np.ndarray,
               image: ImageParameters) -> None:
    """Save raw samples to a file, with a header when the format has one
    (reference: gpujpeg_image_save_to_file + save delegates)."""
    fmt = image_get_file_format(filename)
    data = np.asarray(data, np.uint8).reshape(-1)
    pf = PixelFormat(image.pixel_format)
    desc = PIXEL_FORMAT_DESC[pf]

    if fmt in (FileFormat.PNM, FileFormat.PGM, FileFormat.PPM, FileFormat.PAM):
        if desc.planar or pf == PixelFormat.PF_444_U8_P012Z:
            raise ValueError(f"cannot save {desc.name} as PNM/PAM")
        info = PamInfo(width=image.width, height=image.height,
                       depth=desc.comp_count, maxval=255)
        out = pam_write(info, data, use_pam=(fmt == FileFormat.PAM))
    elif fmt == FileFormat.Y4M:
        sub = {PixelFormat.U8: Y4M_MONO,
               PixelFormat.PF_420_U8_P0P1P2: 420,
               PixelFormat.PF_422_U8_P0P1P2: 422,
               PixelFormat.PF_444_U8_P0P1P2: 444,
               PixelFormat.PF_444_U8_P012A: Y4M_YUVA}.get(pf)
        if sub is None:
            raise ValueError(f"cannot save {desc.name} as Y4M")
        info = Y4mInfo(width=image.width, height=image.height,
                       subsampling=sub,
                       limited=(image.color_space == ColorSpace.YCBCR_BT601))
        out = y4m_write(info, [data])
    else:
        out = data.tobytes()
    with open(filename, "wb") as f:
        f.write(out if isinstance(out, bytes) else bytes(out))


def image_range_info(data: np.ndarray, width: int, height: int,
                     pf: PixelFormat) -> list[tuple[int, int]]:
    """Per-component sample min/max (reference: gpujpeg_image_range_info,
    gpujpeg_common.c:1216-1280)."""
    from ..ops.preprocess import unpack_raw
    chans = unpack_raw(np.asarray(data, np.uint8),
                       ImageParameters(width=width, height=height,
                                       pixel_format=pf), np)
    return [(int(c.min()), int(c.max())) for c in chans]
