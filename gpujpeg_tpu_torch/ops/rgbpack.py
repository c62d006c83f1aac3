"""Forward colour transform of interleaved RGB input, as torch ops.

Counterpart of the JAX reference's words front end (``gpujpeg_tpu/ops/
rgbpack.py``). There the host views the raw bytes as int32 words and an
XLA pass shuffles bytes into plane words before the TPU kernel. On the
card no such relayout is needed: the DCT kernel (``ops/dct.py``, E1)
reads the interleaved ``(H, W, 3)`` bytes itself and applies the same
fixed-point transform per pixel. This module keeps the eligibility rule,
the transform constants and the plain torch form of the transform.

The arithmetic replicates ``colorspace._transform_to`` exactly:
``r = c + (c == 255)`` (equal to ``(c*256)//255`` for 0..255) and
``out = clip(((m.r + 128) >> 8) + base, 0, 255)`` with an arithmetic
shift.
"""
from __future__ import annotations

import torch

from ..types import ColorSpace, PixelFormat
from .colorspace import MATRIX_TO


def rgb_transform_consts(cs_from, cs_to):
    """Static (matrix9, base3) of the forward colour transform; ``()``
    for identity; ``None`` when the pair is not one forward fixed-point
    matrix from RGB."""
    cs_from, cs_to = ColorSpace(cs_from), ColorSpace(cs_to)
    if cs_from in (cs_to, ColorSpace.NONE) or cs_to == ColorSpace.NONE:
        return ()
    if cs_from == ColorSpace.RGB and cs_to in MATRIX_TO:
        return MATRIX_TO[cs_to]
    return None


def pack_consts(plan):
    """(m9, base) int tuples for the plan's colour pair; (None, None) for
    identity; None when the pair is not a single forward RGB matrix."""
    xf = rgb_transform_consts(plan.image.color_space,
                              plan.params.color_space_internal)
    if xf is None:
        return None
    if xf == ():
        return (None, None)
    m9, base = xf
    return (tuple(int(v) for v in m9), tuple(int(v) for v in base))


def pack_eligible(plan) -> bool:
    """True when the device encode can take this plan's raw input
    directly: interleaved 3-byte RGB-order raw, three full-resolution
    components in index order with no MCU padding, word-divisible width,
    and an expressible forward transform."""
    img = plan.image
    comps = plan.components
    return (
        PixelFormat(img.pixel_format) == PixelFormat.PF_444_U8_P012
        and len(comps) == 3
        and all(c.index == i for i, c in enumerate(comps))
        and all(c.width == img.width and c.height == img.height
                and c.data_width == img.width
                and c.data_height == img.height for c in comps)
        and img.width % 4 == 0
        and pack_consts(plan) is not None
    )


def transform_consts_tensor(consts, device) -> torch.Tensor:
    """(13,) int32 kernel argument: m9, base3, then 1 for identity."""
    m9, base = consts
    if m9 is None:
        vals = [0] * 12 + [1]
    else:
        vals = list(m9) + list(base) + [0]
    return torch.tensor(vals, dtype=torch.int32, device=device)


def rgb_to_planes(rgb: torch.Tensor, consts) -> torch.Tensor:
    """Plain form of the transform: (H, W, 3) uint8 -> (3, H, W) int32
    component planes."""
    m9, base = consts
    ch = rgb.permute(2, 0, 1).to(torch.int32)
    if m9 is None:
        return ch
    r = ch + (ch == 255).to(torch.int32)
    out = []
    for i in range(3):
        acc = (m9[3 * i] * r[0] + m9[3 * i + 1] * r[1]
               + m9[3 * i + 2] * r[2] + 128)
        out.append(torch.clamp((acc >> 8) + base[i], 0, 255))
    return torch.stack(out)
