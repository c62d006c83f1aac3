"""Public type system of the PyTorch/CUDA baseline JPEG engine.

Mirrors the capability surface of the reference library's type system
(reference: libgpujpeg/gpujpeg_type.h:69-148, src/gpujpeg_common.c:105-124)
while being an idiomatic Python design: enums + a frozen pixel-format
descriptor registry instead of C enums + a struct table.
"""
from __future__ import annotations

import dataclasses
import enum

#: Maximum number of color components in one JPEG image
#: (reference: gpujpeg_type.h:51).
MAX_COMPONENT_COUNT = 4

#: Maximum number of APP13 segment-info headers in a stream
#: (reference: gpujpeg_type.h:58).
MAX_SEGMENT_INFO_HEADER_COUNT = 100


class ColorSpace(enum.IntEnum):
    """Color spaces (reference: gpujpeg_type.h:69-78). Values kept identical
    to the reference enum so CLI/API behave the same."""

    NONE = 0
    RGB = 1
    #: limited-range YCbCr BT.601
    YCBCR_BT601 = 2
    #: full-range YCbCr BT.601 (the JPEG-native color space)
    YCBCR_BT601_256LVLS = 3
    #: limited-range YCbCr BT.709
    YCBCR_BT709 = 4
    #: deprecated YUV
    YUV = 5


#: Alias used throughout JPEG literature (reference: gpujpeg_type.h:74).
YCBCR_JPEG = ColorSpace.YCBCR_BT601_256LVLS

_CS_NAMES = {
    ColorSpace.NONE: "none",
    ColorSpace.RGB: "RGB",
    ColorSpace.YCBCR_BT601: "YCbCr BT.601",
    ColorSpace.YCBCR_BT601_256LVLS: "YCbCr BT.601 256 Levels (YCbCr JPEG)",
    ColorSpace.YCBCR_BT709: "YCbCr BT.709",
    ColorSpace.YUV: "YUV",
}


def color_space_name(cs: ColorSpace) -> str:
    return _CS_NAMES[ColorSpace(cs)]


class PixelFormat(enum.IntEnum):
    """Raw pixel formats (reference: gpujpeg_type.h:83-113). Same values."""

    NONE = -1
    #: 8bit samples, 1 component (grayscale)
    U8 = 0
    #: 8bit, 3 components, 4:4:4, interleaved (e.g. packed RGB)
    PF_444_U8_P012 = 1
    #: 8bit, 3 components, 4:4:4, planar
    PF_444_U8_P0P1P2 = 2
    #: 8bit, 3 components, 4:2:2, interleaved UYVY order (comp#1 #0 #2 #0)
    PF_422_U8_P1020 = 3
    #: 8bit, 3 components, 4:2:2, planar
    PF_422_U8_P0P1P2 = 4
    #: 8bit, 3 components, 4:2:0, planar
    PF_420_U8_P0P1P2 = 5
    #: 8bit, 3 components, pixel padded to 32 bits with a zero byte, 4:4:4
    PF_444_U8_P012Z = 6
    #: 8bit, 3-4 components, pixel padded to 32 bits with alpha/0xFF, 4:4:4
    PF_444_U8_P012A = 7


class ComponentType(enum.IntEnum):
    """JPEG component class, selects quant/Huffman tables
    (reference: gpujpeg_type.h:131-136)."""

    LUMINANCE = 0
    CHROMINANCE = 1


class HuffmanType(enum.IntEnum):
    """(reference: gpujpeg_type.h:141-146)."""

    DC = 0
    AC = 1


@dataclasses.dataclass(frozen=True)
class SamplingFactor:
    """Per-component sampling factor (reference: gpujpeg_type.h:118-123)."""

    horizontal: int = 0
    vertical: int = 0

    def __str__(self) -> str:
        return f"{self.horizontal}x{self.vertical}"


#: 4:4:4 / 4:2:2 / 4:2:0 presets for 3-component images
#: (reference: gpujpeg_common.c:332-347).
SUBSAMPLING_444 = (SamplingFactor(1, 1), SamplingFactor(1, 1), SamplingFactor(1, 1))
SUBSAMPLING_422 = (SamplingFactor(2, 1), SamplingFactor(1, 1), SamplingFactor(1, 1))
SUBSAMPLING_420 = (SamplingFactor(2, 2), SamplingFactor(1, 1), SamplingFactor(1, 1))


@dataclasses.dataclass(frozen=True)
class PixelFormatDesc:
    """Pixel format metadata (reference: gpujpeg_common.c:105-124)."""

    pixel_format: PixelFormat
    planar: bool
    comp_count: int
    bpp: int  # bytes per pixel; 0 for planar formats
    name: str
    sampling: tuple[SamplingFactor, ...]


def _sf(*pairs: int) -> tuple[SamplingFactor, ...]:
    return tuple(SamplingFactor(pairs[i], pairs[i + 1]) for i in range(0, len(pairs), 2))


PIXEL_FORMAT_DESC: dict[PixelFormat, PixelFormatDesc] = {
    d.pixel_format: d
    for d in (
        PixelFormatDesc(PixelFormat.U8, False, 1, 1, "u8", _sf(1, 1)),
        PixelFormatDesc(PixelFormat.PF_444_U8_P012, False, 3, 3, "444-u8-p012", _sf(1, 1, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_444_U8_P0P1P2, True, 3, 0, "444-u8-p0p1p2", _sf(1, 1, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_422_U8_P1020, False, 3, 2, "422-u8-p1020", _sf(2, 1, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_422_U8_P0P1P2, True, 3, 0, "422-u8-p0p1p2", _sf(2, 1, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_420_U8_P0P1P2, True, 3, 0, "420-u8-p0p1p2", _sf(2, 2, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_444_U8_P012Z, False, 3, 4, "444-u8-p012z", _sf(1, 1, 1, 1, 1, 1)),
        PixelFormatDesc(PixelFormat.PF_444_U8_P012A, False, 4, 4, "444-u8-p012a", _sf(1, 1, 1, 1, 1, 1, 1, 1)),
    )
}


def pixel_format_by_name(name: str) -> PixelFormat:
    for desc in PIXEL_FORMAT_DESC.values():
        if desc.name == name:
            return desc.pixel_format
    raise ValueError(f"unknown pixel format name: {name!r}")


def pixel_format_comp_count(pf: PixelFormat) -> int:
    return PIXEL_FORMAT_DESC[PixelFormat(pf)].comp_count


def image_calculate_size(width: int, height: int, pf: PixelFormat) -> int:
    """Byte size of a raw image (reference: gpujpeg_common.c:1069-1098)."""
    desc = PIXEL_FORMAT_DESC[PixelFormat(pf)]
    if not desc.planar:
        return width * height * desc.bpp
    total = 0
    sf0 = desc.sampling[0]
    for c in range(desc.comp_count):
        sfc = desc.sampling[c]
        cw = (width * sfc.horizontal + sf0.horizontal - 1) // sf0.horizontal
        ch = (height * sfc.vertical + sf0.vertical - 1) // sf0.vertical
        total += cw * ch
    return total


def subsampling_name(sampling: tuple[SamplingFactor, ...], comp_count: int) -> str:
    """J:a:b notation for a sampling-factor set, mirroring
    gpujpeg_subsampling_get_name (reference: gpujpeg_common.c:300-330)."""
    if comp_count == 1:
        return "4:0:0"
    s = tuple(sampling[:comp_count])
    if comp_count >= 3 and s[1] == SamplingFactor(1, 1) and s[2] == SamplingFactor(1, 1):
        h0, v0 = s[0].horizontal, s[0].vertical
        if (h0, v0) == (1, 1):
            return "4:4:4" if comp_count == 3 else "4:4:4:4"
        if (h0, v0) == (2, 1):
            return "4:2:2"
        if (h0, v0) == (2, 2):
            return "4:2:0"
        if (h0, v0) == (1, 2):
            return "4:4:0"
        if (h0, v0) == (4, 1):
            return "4:1:1"
        if (h0, v0) == (4, 2):
            return "4:1:0"
    return "+".join(str(x) for x in s)


class GpujpegError(Exception):
    """Base error (reference error codes: gpujpeg_type.h:61-64)."""


class WrongSubsamplingError(GpujpegError):
    pass


class RestartChangeError(GpujpegError):
    pass
