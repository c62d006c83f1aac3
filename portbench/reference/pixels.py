"""Raw frames <-> component planes, in plain torch on any device.

The encode side unpacks a raw frame of any of GPUJPEG's eight pixel
formats to full-resolution channels (chroma of subsampled formats
repeated), applies the integer colour transform to the stream's colour
space and stores each component subsampled by selection into its plane,
padded to whole MCUs by repeating the edge. The decode side crops each
plane, repeats subsampled chroma to full resolution, transforms to the
output colour space and packs the output format. The integer transforms
are GPUJPEG's 8-bit fixed-point matrices (``gpujpeg_colorspace.h``);
this is a frozen copy of their rules as the program's plain versions
state them (``gpujpeg_tpu_torch/ops/{colorspace,preprocess}.py``).
"""
from __future__ import annotations

import torch

from .geometry import PIXEL_FORMATS, Geometry

#: RGB -> space: (3x3 matrix, row major, 8-bit fixed point; bases)
MATRIX_TO = {
    "YCBCR_BT601": ((66, 129, 25, -38, -74, 112, 112, -94, -18),
                    (16, 128, 128)),
    "YCBCR_BT601_256LVLS": ((77, 150, 29, -43, -85, 128, 128, -107, -21),
                            (0, 128, 128)),
    "YCBCR_BT709": ((47, 157, 16, -26, -87, 112, 112, -102, -10),
                    (16, 128, 128)),
    "YUV": ((77, 150, 29, -38, -74, 112, 157, -132, -26), (0, 128, 128)),
}
#: space -> RGB
MATRIX_FROM = {
    "YCBCR_BT601": ((298, 0, 409, 298, -100, -208, 298, 516, 0),
                    (16, 128, 128)),
    "YCBCR_BT601_256LVLS": ((256, 0, 359, 256, -88, -183, 256, 454, 0),
                            (0, 128, 128)),
    "YCBCR_BT709": ((298, 0, 459, 298, -55, -136, 298, 541, 0),
                    (16, 128, 128)),
    "YUV": ((256, 0, 292, 256, -101, -149, 256, 520, 0), (0, 128, 128)),
}


def _to(ch, space):
    m, base = MATRIX_TO[space]
    r = [(c * 256) // 255 for c in ch]
    return [torch.clamp(((m[3 * i] * r[0] + m[3 * i + 1] * r[1]
                          + m[3 * i + 2] * r[2] + 128) >> 8) + base[i], 0, 255)
            for i in range(3)]


def _from(ch, space):
    m, base = MATRIX_FROM[space]
    r = [torch.div((ch[i] - base[i]) * 256, 255, rounding_mode="trunc")
         for i in range(3)]
    return [torch.clamp((m[3 * i] * r[0] + m[3 * i + 1] * r[1]
                         + m[3 * i + 2] * r[2] + 128) >> 8, 0, 255)
            for i in range(3)]


def transform(channels: list, src: str, dst: str) -> list:
    """Integer colour transform of 3 (or 4, the 4th passed through)
    int32 channels 0..255; two non-RGB spaces go through RGB, clamped."""
    if src in (dst, "NONE") or dst == "NONE" or len(channels) < 3:
        return list(channels)
    ch = list(channels[:3])
    if src != "RGB":
        ch = _from(ch, src)
    if dst != "RGB":
        ch = _to(ch, dst)
    return ch + list(channels[3:])


def unpack(raw: torch.Tensor, width: int, height: int,
           pixel_format: str) -> list:
    """Flat uint8 raw frame -> full-resolution int32 channels (H, W)."""
    planar, bpp, samp = PIXEL_FORMATS[pixel_format]
    H, W = height, width
    raw = raw.reshape(-1).to(torch.int32)
    if pixel_format == "PF_422_U8_P1020":     # U Y V Y
        m = raw.reshape(H, W * 2)
        return [m[:, 1::2], m[:, 0::4].repeat_interleave(2, 1),
                m[:, 2::4].repeat_interleave(2, 1)]
    if not planar:
        m = raw.reshape(H, W * bpp)
        return [m[:, c::bpp] for c in range(len(samp))]
    h0, v0 = samp[0]
    out, pos = [], 0
    for h, v in samp:
        cw, chh = -(-W * h // h0), -(-H * v // v0)
        p = raw[pos:pos + cw * chh].reshape(chh, cw)
        pos += cw * chh
        out.append(p.repeat_interleave(v0 // v, 0)
                   .repeat_interleave(h0 // h, 1)[:H, :W])
    return out


def pack(channels: list, width: int, height: int,
         pixel_format: str) -> torch.Tensor:
    """Full-resolution channels -> the flat raw frame in the channels'
    dtype; subsampled chroma is taken at even positions, absent channels
    are 0 (``Z``) or 255 (``A`` of a 3-channel frame)."""
    planar, bpp, samp = PIXEL_FORMATS[pixel_format]
    H, W = height, width
    ch = list(channels)
    like = dict(dtype=ch[0].dtype, device=ch[0].device)
    if pixel_format == "PF_422_U8_P1020":
        out = torch.empty(H, W * 2, **like)
        out[:, 1::2] = ch[0]
        out[:, 0::4] = ch[1][:, ::2]
        out[:, 2::4] = ch[2][:, ::2]
        return out.reshape(-1)
    if not planar:
        fill = 255 if pixel_format == "PF_444_U8_P012A" else 0
        out = torch.full((H, W * bpp), fill, **like)
        for c in range(min(len(ch), bpp)):
            out[:, c::bpp] = ch[c]
        return out.reshape(-1)
    h0, v0 = samp[0]
    parts = []
    for c, (h, v) in enumerate(samp):
        cw, chh = -(-W * h // h0), -(-H * v // v0)
        rows = torch.clamp(torch.arange(chh, device=like["device"])
                           * (v0 // v), max=H - 1)
        cols = torch.clamp(torch.arange(cw, device=like["device"])
                           * (h0 // h), max=W - 1)
        parts.append(ch[c][rows][:, cols].reshape(-1))
    return torch.cat(parts)


def to_planes(raw: torch.Tensor, geo: Geometry, pixel_format: str,
              space: str, internal: str) -> list:
    """Encode side: raw frame -> one uint8 plane a component, padded to
    whole MCUs by repeating the last row and column."""
    ch = transform(unpack(raw, geo.width, geo.height, pixel_format),
                   space, internal)
    planes = []
    for c in geo.components:
        rx = -(-geo.width // c.width)
        ry = -(-geo.height // c.height)
        p = ch[c.index][::ry, ::rx][:c.height, :c.width]
        p = torch.cat([p, p[-1:].expand(c.data_height - c.height, -1)])
        p = torch.cat([p, p[:, -1:].expand(-1, c.data_width - c.width)], 1)
        planes.append(p.to(torch.uint8).contiguous())
    return planes


def full_res(plane: torch.Tensor, c, geo: Geometry) -> torch.Tensor:
    """A component's plane cropped and repeated to the frame's size."""
    p = plane[:c.height, :c.width]
    p = p.repeat_interleave(-(-geo.height // c.height), 0) \
        .repeat_interleave(-(-geo.width // c.width), 1)
    return p[:geo.height, :geo.width]


def from_planes(planes: list, geo: Geometry, pixel_format: str,
                space: str, internal: str) -> torch.Tensor:
    """Decode side: component planes -> the flat uint8 output frame."""
    ch = [full_res(planes[c.index], c, geo).to(torch.int32)
          for c in geo.components]
    return pack(transform(ch, internal, space), geo.width, geo.height,
                pixel_format).to(torch.uint8)
