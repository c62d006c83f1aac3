"""Integer fixed-point color transforms.

Exact behavioral parity with the reference's 8-bit fixed-point matrices and
rounding (reference: src/gpujpeg_colorspace.h:52-104 for the arithmetic,
:215-351 for the matrices). The functions take an array module
``xp``; the port calls them with ``xp=numpy`` on the host golden path. The
device encode applies the same arithmetic inside its kernels: E1 for one
forward matrix from RGB (``ops/rgbpack.py``), E0 for any pair
(:func:`pair_consts`, ``csrc/preprocess.cu``), whose plain torch form is
:func:`apply_pair`.

Semantics replicated exactly:

* forward (``to``):   r = c*256/255 (c in 0..255, floor division),
  out_i = clamp(((m3i·r + 128) >> 8) + base_i)
* inverse (``from``): r = (c - base)*256/255 with **C truncation toward
  zero** (operand may be negative), out_i = clamp((m3i·r + 128) >> 8)
* transforms between two non-RGB spaces are composed through RGB with
  intermediate clamping, as the reference does via uchar4
  (gpujpeg_colorspace.h:353-427).
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import ColorSpace

#: RGB -> cs matrices (row-major 3x3, 8-bit fixed point) and output bases
#: (reference: gpujpeg_colorspace.h:228,263,298,333).
MATRIX_TO = {
    ColorSpace.YCBCR_BT601: ((66, 129, 25, -38, -74, 112, 112, -94, -18), (16, 128, 128)),
    ColorSpace.YCBCR_BT601_256LVLS: ((77, 150, 29, -43, -85, 128, 128, -107, -21), (0, 128, 128)),
    ColorSpace.YCBCR_BT709: ((47, 157, 16, -26, -87, 112, 112, -102, -10), (16, 128, 128)),
    ColorSpace.YUV: ((77, 150, 29, -38, -74, 112, 157, -132, -26), (0, 128, 128)),
}

#: cs -> RGB matrices and input bases
#: (reference: gpujpeg_colorspace.h:246,281,316,349).
MATRIX_FROM = {
    ColorSpace.YCBCR_BT601: ((298, 0, 409, 298, -100, -208, 298, 516, 0), (16, 128, 128)),
    ColorSpace.YCBCR_BT601_256LVLS: ((256, 0, 359, 256, -88, -183, 256, 454, 0), (0, 128, 128)),
    ColorSpace.YCBCR_BT709: ((298, 0, 459, 298, -55, -136, 298, 541, 0), (16, 128, 128)),
    ColorSpace.YUV: ((256, 0, 292, 256, -101, -149, 256, 520, 0), (0, 128, 128)),
}


def _clamp_u8(x, xp):
    return xp.clip(x, 0, 255)


def _expand(c, xp):
    """c*256/255 for non-negative c (floor == C truncation here)."""
    return (c * 256) // 255


def _expand_signed(c, xp):
    """(c)*256/255 with C truncation toward zero for possibly-negative c."""
    q = c * 256
    return xp.sign(q) * (xp.abs(q) // 255)


def _transform_to(channels, cs, xp):
    """RGB (list of 3 int32 arrays) -> cs."""
    m, base = MATRIX_TO[cs]
    r = [_expand(ch, xp) for ch in channels]
    out = []
    for i in range(3):
        acc = m[3 * i] * r[0] + m[3 * i + 1] * r[1] + m[3 * i + 2] * r[2]
        out.append(_clamp_u8(((acc + 128) >> 8) + base[i], xp))
    return out


def _transform_from(channels, cs, xp):
    """cs -> RGB."""
    m, base = MATRIX_FROM[cs]
    r = [_expand_signed(channels[i] - base[i], xp) for i in range(3)]
    out = []
    for i in range(3):
        acc = m[3 * i] * r[0] + m[3 * i + 1] * r[1] + m[3 * i + 2] * r[2]
        out.append(_clamp_u8((acc + 128) >> 8, xp))
    return out


def transform(channels, cs_from: ColorSpace, cs_to: ColorSpace, xp=np):
    """Transform a list of 3 (or 4) same-shaped integer arrays in place of the
    reference's per-pixel uchar4 templates. Channel 4 (alpha) passes through.
    Input values must be 0..255; output is 0..255 (int32).
    """
    cs_from, cs_to = ColorSpace(cs_from), ColorSpace(cs_to)
    alpha = list(channels[3:])
    channels = [xp.asarray(ch).astype(xp.int32) for ch in channels[:3]]
    if cs_from in (cs_to, ColorSpace.NONE) or cs_to == ColorSpace.NONE or len(channels) < 3:
        return channels + alpha
    if cs_from == ColorSpace.RGB:
        out = _transform_to(channels, cs_to, xp)
    elif cs_to == ColorSpace.RGB:
        out = _transform_from(channels, cs_from, xp)
    else:
        rgb = _transform_from(channels, cs_from, xp)
        out = _transform_to(rgb, cs_to, xp)
    return out + alpha


#: length of :func:`pair_consts`: (flag, m9, base3) of the inverse, then
#: of the forward matrix
PAIR_CONSTS = 26


def pair_consts(cs_from, cs_to, n_channels: int) -> tuple[int, ...]:
    """The integer constants of :func:`transform` for one colour pair, as
    the E0 kernel takes them: ``(1, m9, base3)`` of the inverse matrix
    to RGB, then of the forward matrix from RGB, each ``(0,) * 13`` where
    that step is absent. Both steps are absent for the identity (equal
    spaces, NONE, or fewer than 3 channels); a pair of two non-RGB
    spaces takes both, through RGB with the clamp between."""
    cs_from, cs_to = ColorSpace(cs_from), ColorSpace(cs_to)
    inv = fwd = None
    if not (cs_from in (cs_to, ColorSpace.NONE) or cs_to == ColorSpace.NONE
            or n_channels < 3):
        if cs_from != ColorSpace.RGB:
            inv = MATRIX_FROM[cs_from]
        if cs_to != ColorSpace.RGB:
            fwd = MATRIX_TO[cs_to]
    out: list[int] = []
    for step in (inv, fwd):
        out += [0] * 13 if step is None else [1, *step[0], *step[1]]
    return tuple(int(v) for v in out)


def apply_pair(channels: list, consts) -> list:
    """Plain torch form of :func:`transform` driven by :func:`pair_consts`:
    same-shaped int32 tensors (0..255) -> int32 tensors (0..255); a
    fourth channel (alpha) passes through."""
    consts = [int(v) for v in consts]
    if len(channels) < 3:
        return list(channels)
    ch = list(channels[:3])
    if consts[0]:
        m, base = consts[1:10], consts[10:13]
        r = [torch.div((ch[i] - base[i]) * 256, 255, rounding_mode="trunc")
             for i in range(3)]
        ch = [torch.clamp((m[3 * i] * r[0] + m[3 * i + 1] * r[1]
                           + m[3 * i + 2] * r[2] + 128) >> 8, 0, 255)
              for i in range(3)]
    if consts[13]:
        m, base = consts[14:23], consts[23:26]
        r = [c + (c == 255).to(c.dtype) for c in ch]
        ch = [torch.clamp(((m[3 * i] * r[0] + m[3 * i + 1] * r[1]
                            + m[3 * i + 2] * r[2] + 128) >> 8) + base[i],
                          0, 255)
              for i in range(3)]
    return ch + list(channels[3:])
