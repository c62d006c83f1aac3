"""JPEG marker codes (reference: src/gpujpeg_marker.h:40-112)."""
from __future__ import annotations

import enum


class Marker(enum.IntEnum):
    SOF0 = 0xC0  # baseline DCT
    SOF1 = 0xC1  # extended sequential DCT
    SOF2 = 0xC2  # progressive DCT
    SOF3 = 0xC3
    DHT = 0xC4
    SOF5 = 0xC5
    SOF6 = 0xC6
    SOF7 = 0xC7
    JPG = 0xC8
    SOF9 = 0xC9
    SOF10 = 0xCA
    SOF11 = 0xCB
    DAC = 0xCC
    SOF13 = 0xCD
    SOF14 = 0xCE
    SOF15 = 0xCF
    RST0 = 0xD0
    RST1 = 0xD1
    RST2 = 0xD2
    RST3 = 0xD3
    RST4 = 0xD4
    RST5 = 0xD5
    RST6 = 0xD6
    RST7 = 0xD7
    SOI = 0xD8
    EOI = 0xD9
    SOS = 0xDA
    DQT = 0xDB
    DNL = 0xDC
    DRI = 0xDD
    DHP = 0xDE
    EXP = 0xDF
    APP0 = 0xE0
    APP1 = 0xE1
    APP2 = 0xE2
    APP3 = 0xE3
    APP4 = 0xE4
    APP5 = 0xE5
    APP6 = 0xE6
    APP7 = 0xE7
    APP8 = 0xE8
    APP9 = 0xE9
    APP10 = 0xEA
    APP11 = 0xEB
    APP12 = 0xEC
    APP13 = 0xED
    APP14 = 0xEE
    APP15 = 0xEF
    JPG0 = 0xF0
    JPG13 = 0xFD
    COM = 0xFE
    TEM = 0x01


#: GPUJPEG uses APP13 for its segment-info extension
#: (reference: gpujpeg_marker.h:94, gpujpeg_reader.c:325).
MARKER_SEGMENT_INFO = Marker.APP13

# SPIFF constants (reference: gpujpeg_marker.h:107-112)
APP14_ADOBE_MARKER_LEN = 14
SPIFF_VERSION = 0x100
SPIFF_COMPRESSION_JPEG = 5
SPIFF_ENTRY_TAG_EOD = 0x1
SPIFF_ENTRY_TAG_EOD_LENGTH = 8
SPIFF_MARKER_LEN = 32

#: SPIFF color-space ids <-> internal color spaces
#: (reference: gpujpeg_writer.c:177-199, gpujpeg_reader.c:420-470)
SPIFF_CS_BT709 = 1
SPIFF_CS_NONE = 2
SPIFF_CS_BT601_FULL = 3  # with JFIF-compatible full range
SPIFF_CS_BT601_LIMITED = 4
SPIFF_CS_GRAY = 8
SPIFF_CS_RGB = 10


def marker_name(code: int) -> str:
    try:
        return Marker(code).name
    except ValueError:
        return f"0x{code:02x}"
