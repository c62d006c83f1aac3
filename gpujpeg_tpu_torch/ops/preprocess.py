"""Preprocessor (encode: raw image -> component planes) and postprocessor
(decode: component planes -> raw image).

Behavioral analog of the reference's template-matrix CUDA kernels
(reference: src/gpujpeg_preprocessor.cu:92-212, src/gpujpeg_postprocessor.cu:
49-251): unpack any of the 8 raw pixel formats to full-resolution channels
(nearest-neighbor chroma replication), apply the integer color transform,
then subsample-store into MCU-padded per-component planes — and the inverse.

The port runs this module on the host with ``xp=numpy`` (the golden
coder's preprocess and the golden decoder's postprocess). Packed pixel
data is viewed as ``(H, W*bpp)`` and channels are extracted with
minor-dim strided slices. The device encode of interleaved RGB input
folds this stage into its DCT kernel (``ops/dct.py``).
"""
from __future__ import annotations

import numpy as np

from ..params import ImageParameters
from ..plan import CoderPlan
from ..types import PixelFormat, PIXEL_FORMAT_DESC
from .colorspace import transform


def _edge_pad(plane, dh: int, dw: int, xp):
    h, w = plane.shape
    if h == dh and w == dw:
        return plane
    return xp.pad(plane, ((0, dh - h), (0, dw - w)), mode="edge")


def _deinterleave(raw, H: int, W: int, step: int, xp):
    """(H*W*step,) u8 -> ``step`` channels (H, W) via lane-stride slices."""
    m = raw.reshape(H, W * step)
    return [m[:, c::step] for c in range(step)]


def _interleave(channels, H: int, W: int, step: int, xp, fill: int = 0):
    """channels (H, W) -> (H*W*step,) u8, scattering into lane strides."""
    out = np.full((H, W * step), fill, np.uint8)
    for c, ch in enumerate(channels):
        out[:, c::step] = ch
    return out.reshape(-1)


def unpack_raw(raw, image: ImageParameters, xp=np):
    """Raw image buffer -> list of full-resolution channels (H, W) int32.

    Chroma of subsampled input formats is replicated to full resolution
    (nearest), mirroring the reference loaders
    (gpujpeg_preprocessor.cu:92-167)."""
    pf = PixelFormat(image.pixel_format)
    desc = PIXEL_FORMAT_DESC[pf]
    H, W = image.height, image.width
    raw = xp.asarray(raw).reshape(-1).astype(xp.uint8)

    if pf == PixelFormat.U8:
        return [raw.reshape(H, W).astype(xp.int32)]
    if pf == PixelFormat.PF_444_U8_P012:
        return [c.astype(xp.int32) for c in _deinterleave(raw, H, W, 3, xp)]
    if pf in (PixelFormat.PF_444_U8_P012Z, PixelFormat.PF_444_U8_P012A):
        chans = _deinterleave(raw, H, W, 4, xp)
        n = 4 if (desc.comp_count == 4 or image.comp_count == 4) else 3
        return [c.astype(xp.int32) for c in chans[:n]]
    if pf == PixelFormat.PF_422_U8_P1020:
        # byte order per 2 pixels: comp#1 comp#0 comp#2 comp#0 (U Y V Y)
        m = raw.reshape(H, W * 2)
        y = m[:, 1::2].astype(xp.int32)
        u = xp.repeat(m[:, 0::4].astype(xp.int32), 2, axis=1)
        v = xp.repeat(m[:, 2::4].astype(xp.int32), 2, axis=1)
        return [y, u, v]
    if pf in (PixelFormat.PF_444_U8_P0P1P2, PixelFormat.PF_422_U8_P0P1P2,
              PixelFormat.PF_420_U8_P0P1P2):
        sf = desc.sampling
        max_h = sf[0].horizontal
        max_v = sf[0].vertical
        chans = []
        pos = 0
        for c in range(3):
            cw = -(-W * sf[c].horizontal // max_h)
            ch = -(-H * sf[c].vertical // max_v)
            plane = raw[pos:pos + cw * ch].reshape(ch, cw).astype(xp.int32)
            pos += cw * ch
            rx = max_h // sf[c].horizontal
            ry = max_v // sf[c].vertical
            if rx > 1 or ry > 1:
                plane = xp.repeat(xp.repeat(plane, ry, axis=0), rx, axis=1)[:H, :W]
            chans.append(plane)
        return chans
    raise ValueError(f"unsupported pixel format {pf}")


def pack_raw(channels, image: ImageParameters, xp=np):
    """Full-resolution channels -> raw image buffer (flat uint8)."""
    pf = PixelFormat(image.pixel_format)
    desc = PIXEL_FORMAT_DESC[pf]
    H, W = image.height, image.width
    channels = [xp.asarray(c) for c in channels]

    if pf == PixelFormat.U8:
        return channels[0].astype(xp.uint8).reshape(-1)
    if pf == PixelFormat.PF_444_U8_P012:
        return _interleave(channels[:3], H, W, 3, xp)
    if pf == PixelFormat.PF_444_U8_P012Z:
        return _interleave(channels[:3], H, W, 4, xp, fill=0)
    if pf == PixelFormat.PF_444_U8_P012A:
        if len(channels) >= 4:
            return _interleave(channels[:4], H, W, 4, xp)
        # alpha fill 0xFF when decoding 3-comp JPEG to p012a
        # (reference: gpujpeg_postprocessor.cu:247-249)
        return _interleave(channels[:3], H, W, 4, xp, fill=255)
    if pf == PixelFormat.PF_422_U8_P1020:
        y, u, v = channels[:3]
        out = np.empty((H, W * 2), np.uint8)
        out[:, 1::2] = y
        out[:, 0::4] = u[:, ::2]
        out[:, 2::4] = v[:, ::2]
        return out.reshape(-1)
    if pf in (PixelFormat.PF_444_U8_P0P1P2, PixelFormat.PF_422_U8_P0P1P2,
              PixelFormat.PF_420_U8_P0P1P2):
        sf = desc.sampling
        max_h, max_v = sf[0].horizontal, sf[0].vertical
        parts = []
        for c in range(3):
            rx = max_h // sf[c].horizontal
            ry = max_v // sf[c].vertical
            cw = -(-W * sf[c].horizontal // max_h)
            ch = -(-H * sf[c].vertical // max_v)
            row_idx = xp.minimum(xp.arange(ch) * ry, H - 1)
            col_idx = xp.minimum(xp.arange(cw) * rx, W - 1)
            parts.append(channels[c][row_idx][:, col_idx].astype(xp.uint8).reshape(-1))
        return xp.concatenate(parts)
    raise ValueError(f"unsupported pixel format {pf}")


def preprocess(raw, image: ImageParameters, plan: CoderPlan, xp=np):
    """Encode-side preprocessor: raw -> list of MCU-padded uint8 planes
    (reference: gpujpeg_preprocessor_encode, gpujpeg_preprocessor.cu:479)."""
    channels = unpack_raw(raw, image, xp)
    channels = transform(channels, image.color_space,
                         plan.params.color_space_internal, xp)
    H, W = image.height, image.width
    planes = []
    for comp in plan.components:
        chan = channels[comp.index]
        # subsample by selection (reference store skips non-sampled
        # positions: gpujpeg_preprocessor.cu:48-62)
        rx = (W + comp.width - 1) // comp.width if comp.width else 1
        ry = (H + comp.height - 1) // comp.height if comp.height else 1
        if rx > 1 or ry > 1:
            sel = chan[::ry, ::rx][:comp.height, :comp.width]
        else:
            sel = chan
        plane = _edge_pad(sel.astype(xp.uint8), comp.data_height, comp.data_width, xp)
        planes.append(plane)
    return planes


def postprocess(planes, out_image: ImageParameters, plan: CoderPlan, xp=np):
    """Decode-side postprocessor: planes -> raw image buffer
    (reference: gpujpeg_preprocessor_decode, gpujpeg_postprocessor.cu:467)."""
    H, W = out_image.height, out_image.width
    channels = []
    for comp in plan.components:
        plane = xp.asarray(planes[comp.index])[:comp.height, :comp.width]
        ry = -(-H // comp.height) if comp.height else 1
        rx = -(-W // comp.width) if comp.width else 1
        if rx > 1 or ry > 1:
            plane = xp.repeat(xp.repeat(plane, ry, axis=0), rx, axis=1)
        channels.append(plane[:H, :W].astype(xp.int32))
    channels = transform(channels, plan.params.color_space_internal,
                         out_image.color_space, xp)
    return pack_raw(channels, out_image, xp)
