"""Colour transforms of interleaved RGB input and output, as torch ops.

Counterpart of the JAX reference's words front end and its decode
mirror (``gpujpeg_tpu/ops/rgbpack.py``). There the host views the raw
bytes as int32 words and XLA passes shuffle bytes between raw and plane
words around the TPU kernels. On the card no such relayout is needed:
the DCT kernel (``ops/dct.py``, E1) reads the interleaved ``(H, W, 3)``
bytes itself and applies the forward fixed-point transform per pixel,
and the IDCT kernel (D2) applies the inverse and writes the interleaved
bytes. This module keeps the eligibility rules, the transform constants
and the plain torch forms of both transforms.

The forward arithmetic replicates ``colorspace._transform_to`` exactly:
``r = c + (c == 255)`` (equal to ``(c*256)//255`` for 0..255) and
``out = clip(((m.r + 128) >> 8) + base, 0, 255)`` with an arithmetic
shift; the inverse replicates ``colorspace._transform_from``
(:func:`planes_to_rgb`). Both plain forms apply the arithmetic through
``colorspace.apply_pair``.
"""
from __future__ import annotations

import torch

from ..types import ColorSpace, PixelFormat
from .colorspace import MATRIX_FROM, MATRIX_TO, apply_pair


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


def unpack_consts(plan, out_image):
    """(m9, base) of the inverse transform from the decode colour pair;
    (None, None) for identity; None when the pair is not a single inverse
    matrix to RGB."""
    cs_from = ColorSpace(plan.params.color_space_internal)
    cs_to = ColorSpace(out_image.color_space)
    if cs_from in (cs_to, ColorSpace.NONE) or cs_to == ColorSpace.NONE:
        return (None, None)
    if cs_to == ColorSpace.RGB and cs_from in MATRIX_FROM:
        m9, base = MATRIX_FROM[cs_from]
        return (tuple(int(v) for v in m9), tuple(int(v) for v in base))
    return None


def unpack_eligible(plan, out_image) -> bool:
    """True when the device decode can write this output directly:
    interleaved 3-byte RGB-order raw at full resolution from three
    equal full-resolution components in index order, and an expressible
    inverse transform."""
    img = plan.image
    comps = plan.components
    return (
        PixelFormat(out_image.pixel_format) == PixelFormat.PF_444_U8_P012
        and out_image.width == img.width
        and out_image.height == img.height
        and len(comps) == 3
        and all(c.index == i for i, c in enumerate(comps))
        and all(c.width == img.width and c.height == img.height
                and c.data_width == img.width
                and c.data_height == img.height for c in comps)
        and unpack_consts(plan, out_image) is not None
    )


def planes_to_rgb(planes: torch.Tensor, consts) -> torch.Tensor:
    """Plain form of the inverse transform: (3, H, W) int32 component
    planes (0..255) -> (H, W, 3) uint8 raw pixels. Replicates
    ``colorspace._transform_from``: ``r = (c - base)*256/255`` truncated
    toward zero, ``out = clip((m.r + 128) >> 8, 0, 255)`` with an
    arithmetic shift."""
    m9, base = consts
    if m9 is not None:
        planes = torch.stack(apply_pair(list(planes),
                                        (1, *m9, *base) + (0,) * 13))
    return planes.permute(1, 2, 0).to(torch.uint8).contiguous()


def rgb_to_planes(rgb: torch.Tensor, consts) -> torch.Tensor:
    """Plain form of the transform: (H, W, 3) uint8 -> (3, H, W) int32
    component planes."""
    m9, base = consts
    ch = rgb.permute(2, 0, 1).to(torch.int32)
    if m9 is None:
        return ch
    return torch.stack(apply_pair(list(ch), (0,) * 13 + (1, *m9, *base)))
