"""Preprocessor (encode: raw image -> component planes) and postprocessor
(decode: component planes -> raw image).

Behavioral analog of the reference's template-matrix CUDA kernels
(reference: src/gpujpeg_preprocessor.cu:92-212, src/gpujpeg_postprocessor.cu:
49-251): unpack any of the 8 raw pixel formats to full-resolution channels
(nearest-neighbor chroma replication), apply the integer color transform,
then subsample-store into MCU-padded per-component planes — and the inverse.

The port runs :func:`preprocess` and :func:`postprocess` on the host
with ``xp=numpy`` (the golden coder's preprocess and the golden
decoder's postprocess). Packed pixel data is viewed as ``(H, W*bpp)``
and channels are extracted with minor-dim strided slices.

**E0** :func:`preprocess_planes` is the device form of
:func:`preprocess` for every pixel format, colour pair and sampling: the
wrapper of the hand-written CUDA kernel ``csrc/preprocess.cu``. It
replaces the XLA preprocess of the JAX reference's staged and fused
encodes (``gpujpeg_tpu/ops/preprocess.py:150``, traced inside
``jax_pipeline._EncContext._build_fn``). Its output is the MCU-padded u8
planes concatenated in component order, which E1p
(``ops/dct.py:fdct_quant_planes``) reads. :func:`preprocess_planes_plain`
is its plain torch version; the wrapper takes it only for tensors on the
CPU. The device encode of interleaved RGB 4:4:4 input skips E0: its DCT
kernel E1 reads the raw bytes itself.

**D3** :func:`postprocess_planes` is E0's mirror, the device form of
:func:`postprocess` for every pixel format, colour pair and sampling:
the wrapper of ``csrc/postprocess.cu``. It replaces the XLA postprocess
of the JAX reference's plan tail (``gpujpeg_tpu/ops/preprocess.py:173``,
after K4 or K5 in ``jax_pipeline._decode_device_v2``) and reads the
planes that D2p (``ops/dct.py:idct_planes``) writes, whose layout
:func:`block_geometry` describes for both E1p and D2p.
:func:`postprocess_planes_plain` is its plain torch version. The device
decode of three full-resolution components to interleaved RGB skips D3:
its IDCT kernel D2 writes the RGB bytes itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..params import ImageParameters
from ..plan import CoderPlan
from ..types import PixelFormat, PIXEL_FORMAT_DESC
from .colorspace import PAIR_CONSTS, apply_pair, pair_consts, transform


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


# ---------------------------------------------------------------------------
# E0: the device preprocessor
# ---------------------------------------------------------------------------

_PLANAR = (PixelFormat.PF_444_U8_P0P1P2, PixelFormat.PF_422_U8_P0P1P2,
           PixelFormat.PF_420_U8_P0P1P2)
#: columns of :attr:`PlaneGeometry.comp`
COMP_COLS = 8
#: columns of :attr:`PlaneGeometry.src`
SRC_COLS = 5
#: raw rows a CTA of E0 takes, output rows a CTA of D3 takes
#: (``kBandRows`` of both kernels)
BAND_ROWS = 8


def magic(d: int) -> int:
    """The multiplier of ``pixio::div_magic`` (``csrc/pixel_io.cuh``) for
    divisor ``d``: x / d = (2x * m) >> 32 with m = ceil(2**31 / d)."""
    return -(-(1 << 31) // d)


def magic_exact(d: int, x_max: int) -> bool:
    """Whether ``div_magic`` with :func:`magic` (d) is exact for every
    0 <= x <= x_max. (2x * m) >> 32 is floor(x / d + e) with
    e = x * (m * d - 2**31) / (d * 2**31); it equals x // d where e < 1 / d,
    which x_max * (m * d - 2**31) < 2**31 ensures."""
    return x_max < 1 << 30 and x_max * (magic(d) * d - (1 << 31)) < 1 << 31


def _planar_inputs(image: ImageParameters) -> list[tuple[int, ...]]:
    """Per input plane of a planar format: (byte offset, width, height,
    column and row replication to full resolution), as ``unpack_raw``
    lays them out."""
    sf = PIXEL_FORMAT_DESC[PixelFormat(image.pixel_format)].sampling
    max_h, max_v = sf[0].horizontal, sf[0].vertical
    rows, pos = [], 0
    for c in range(3):
        cw = -(-image.width * sf[c].horizontal // max_h)
        ch = -(-image.height * sf[c].vertical // max_v)
        rows.append((pos, cw, ch, max_h // sf[c].horizontal,
                     max_v // sf[c].vertical))
        pos += cw * ch
    return rows


def raw_size(image: ImageParameters) -> int:
    """Bytes of one raw frame in the image's pixel format."""
    pf = PixelFormat(image.pixel_format)
    if pf in _PLANAR:
        return sum(cw * ch for _, cw, ch, _, _ in _planar_inputs(image))
    return image.width * image.height * PIXEL_FORMAT_DESC[pf].bpp


def upload_raw(raw, image: ImageParameters, device,
               staging=None) -> torch.Tensor:
    """A raw frame in any pixel format -> its flat uint8 bytes on
    ``device``. ``raw`` is bytes, a NumPy array or a tensor: a uint8
    tensor as it is, an int32 one as its little-endian bytes (the JAX
    package's words form; the host and the card are both little-endian).
    A tensor already on ``device`` is not copied (a view where it is
    contiguous); one on another device is copied there once, never
    through NumPy. Raises ValueError for a tensor of another dtype, when
    the byte count is not the format's (:func:`raw_size`), or for UYVY of
    odd width, which the reference's loader cannot unpack either.
    ``staging`` (a ``pipeline.PinnedRing``) carries host bytes to the
    card through pinned memory without blocking the host."""
    if isinstance(raw, torch.Tensor):
        if raw.dtype == torch.int32:
            raw = raw.contiguous().view(torch.uint8)
        elif raw.dtype != torch.uint8:
            raise ValueError(f"a raw frame tensor must be uint8 or int32, "
                             f"got {raw.dtype}")
        a = raw.reshape(-1)
    else:
        a = np.frombuffer(raw, np.uint8) if isinstance(
            raw, (bytes, bytearray, memoryview)) else np.asarray(raw,
                                                                 np.uint8)
        a = a.reshape(-1)
    n = raw_size(image)
    if a.shape[0] != n:
        raise ValueError(f"raw frame holds {a.shape[0]} bytes, "
                         f"{PixelFormat(image.pixel_format).name} "
                         f"{image.width}x{image.height} needs {n}")
    if (PixelFormat(image.pixel_format) == PixelFormat.PF_422_U8_P1020
            and image.width % 2):
        raise ValueError("PF_422_U8_P1020 needs an even width")
    if isinstance(a, np.ndarray):
        if staging is not None:
            return staging.upload(a, device)
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Where each scan-order block of a plan lies in its MCU-padded
    component planes (concatenated in component order, each (data_height,
    data_width) row-major): what E1p reads its blocks from and D2p writes
    its pixels to, on one device."""

    #: (C, 4) int32 per plane: byte offset, data width, first plane
    #: block, blocks per row
    blk: torch.Tensor
    #: (NB,) int32 scan order -> plane order (``plan.block_plane_idx``)
    block_plane_idx: torch.Tensor
    total: int                    # bytes of all planes


def block_geometry(plan: CoderPlan, device) -> BlockGeometry:
    blk, off = [], 0
    for c in plan.components:
        blk.append((off, c.data_width, c.plane_block_offset,
                    c.block_count_x))
        off += c.data_width * c.data_height
    if off >= 1 << 31:
        raise ValueError(f"planes of {off} bytes are out of range")
    return BlockGeometry(blk=_i32(blk, device),
                         block_plane_idx=_i32(plan.block_plane_idx, device),
                         total=off)


@dataclasses.dataclass(frozen=True)
class PlaneGeometry(BlockGeometry):
    """The operands of E0 and E1p for one plan, on one device: the block
    geometry and E0's own."""

    fmt: int                      # PixelFormat of the raw input
    height: int
    width: int
    n_ch: int                     # channels unpacked from the raw input
    raw_bytes: int                # bytes of one raw frame (``raw_size``)
    #: (C, COMP_COLS) int32 per output plane: byte offset in the output,
    #: data width, data height, selected rows, selected columns, row and
    #: column selection step, channel index
    comp: torch.Tensor
    #: (3, SRC_COLS) int32 per input plane of a planar format: byte
    #: offset, width, height, column and row replication (zeros otherwise)
    src: torch.Tensor
    #: (PAIR_CONSTS,) int32 colour-pair constants (``pair_consts``)
    xf: torch.Tensor
    #: (n_bands + 1, C) int32, n_bands = ceil(height / BAND_ROWS): the
    #: first row of each plane that band b writes; band b's rows of plane
    #: c are ``bands[b, c]:bands[b + 1, c]``, those that select from raw
    #: rows [b * BAND_ROWS, (b + 1) * BAND_ROWS) (:func:`plane_bands`)
    bands: torch.Tensor
    #: the C entry's host words: fmt, height, width, C, ``comp``, ``src``,
    #: ``xf`` (int32)
    host: np.ndarray


def plane_bands(comp, H: int) -> np.ndarray:
    """E0's band table from ``PlaneGeometry.comp`` rows: plane row y
    selects raw row min(y, rows_sel - 1) * ry, which lies in band
    ``// BAND_ROWS``; padding rows go with the last selected row. Each
    plane's rows are cut into consecutive runs, one per band, so every
    row has exactly one band."""
    n = -(-H // BAND_ROWS)
    out = np.zeros((n + 1, len(comp)), np.int32)
    for c, (_, _, dh, rows_sel, _, ry, _, _) in enumerate(comp):
        band = np.minimum(np.arange(dh), rows_sel - 1) * ry // BAND_ROWS
        out[:, c] = np.searchsorted(band, np.arange(n + 1), side="left")
    return out


def plane_geometry(plan: CoderPlan, device) -> PlaneGeometry:
    img = plan.image
    H, W = img.height, img.width
    pf = PixelFormat(img.pixel_format)
    desc = PIXEL_FORMAT_DESC[pf]
    n_ch = (4 if desc.comp_count == 4 or img.comp_count == 4 else 3) \
        if pf in (PixelFormat.PF_444_U8_P012Z, PixelFormat.PF_444_U8_P012A) \
        else desc.comp_count
    comp, off = [], 0
    for c in plan.components:
        # subsample by selection, as ``preprocess`` does
        rx = -(-W // c.width) if c.width else 1
        ry = -(-H // c.height) if c.height else 1
        rows_sel = min(c.height, -(-H // ry))
        cols_sel = min(c.width, -(-W // rx))
        comp.append((off, c.data_width, c.data_height, rows_sel, cols_sel,
                     ry, rx, c.index))
        off += c.data_width * c.data_height
    src = _planar_inputs(img) if pf in _PLANAR else [(0,) * SRC_COLS] * 3
    xf = pair_consts(img.color_space, plan.params.color_space_internal, n_ch)
    b = block_geometry(plan, device)
    host = np.array([int(pf), H, W, len(comp)]
                    + [v for row in comp + list(src) for v in row]
                    + list(xf), np.int32)
    return PlaneGeometry(
        blk=b.blk, block_plane_idx=b.block_plane_idx, total=b.total,
        fmt=int(pf), height=H, width=W, n_ch=n_ch, raw_bytes=raw_size(img),
        comp=_i32(comp, device), src=_i32(src, device), xf=_i32(xf, device),
        bands=_i32(plane_bands(comp, H), device), host=host)


def _check_e0(raw: torch.Tensor, g: PlaneGeometry) -> None:
    if raw.dtype != torch.uint8 or tuple(raw.shape) != (g.raw_bytes,):
        raise ValueError(f"raw must be ({g.raw_bytes},) uint8, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    C = g.comp.shape[0]
    n_bands = -(-g.height // BAND_ROWS)
    for name, t, shape in (("comp", g.comp, (C, COMP_COLS)),
                           ("src", g.src, (3, SRC_COLS)),
                           ("xf", g.xf, (PAIR_CONSTS,)),
                           ("bands", g.bands, (n_bands + 1, C))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (raw, g.comp, g.src, g.xf, g.bands):
        if t.device != raw.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if not 1 <= C <= 4 or g.total <= 0 or max(g.total, g.raw_bytes) >= 1 << 31:
        raise ValueError(f"{C} planes of {g.total} bytes from {g.raw_bytes} "
                         "raw bytes are out of range")
    if raw.device.type == "cuda" and raw.data_ptr() % 4:
        raise ValueError("raw must be 4-byte aligned on the card")


def preprocess_planes(raw: torch.Tensor, g: PlaneGeometry) -> torch.Tensor:
    """(n,) uint8 raw frame (:func:`upload_raw`) -> (g.total,) uint8: the
    plan's MCU-padded component planes, concatenated in component
    order, each (data_height, data_width) row-major."""
    _check_e0(raw, g)
    if raw.device.type == "cpu":
        return preprocess_planes_plain(raw, g)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    out = torch.empty((g.total,), dtype=torch.uint8, device=raw.device)
    _build.launch(
        "gj_preprocess_planes", raw.device, raw.data_ptr(),
        g.host.ctypes.data, g.bands.data_ptr(), g.bands.shape[0] - 1,
        out.data_ptr())
    preprocess_planes.launches += 1
    return out


preprocess_planes.launches = 0


def _unpack_plain(raw: torch.Tensor, g: PlaneGeometry) -> list:
    """``unpack_raw`` in torch: full-resolution int32 channels (H, W)."""
    H, W, pf = g.height, g.width, PixelFormat(g.fmt)
    if pf == PixelFormat.U8:
        return [raw.view(H, W).to(torch.int32)]
    if pf == PixelFormat.PF_444_U8_P012:
        m = raw.view(H, W, 3).to(torch.int32)
        return [m[..., c] for c in range(3)]
    if pf in (PixelFormat.PF_444_U8_P012Z, PixelFormat.PF_444_U8_P012A):
        m = raw.view(H, W, 4).to(torch.int32)
        return [m[..., c] for c in range(g.n_ch)]
    if pf == PixelFormat.PF_422_U8_P1020:
        # byte order per 2 pixels: comp#1 comp#0 comp#2 comp#0 (U Y V Y)
        m = raw.view(H, 2 * W).to(torch.int32)
        return [m[:, 1::2], m[:, 0::4].repeat_interleave(2, dim=1),
                m[:, 2::4].repeat_interleave(2, dim=1)]
    chans = []
    for off, cw, ch, rx, ry in g.src.tolist():
        plane = raw[off:off + cw * ch].view(ch, cw).to(torch.int32)
        chans.append(plane.repeat_interleave(ry, dim=0)
                     .repeat_interleave(rx, dim=1)[:H, :W])
    return chans


def preprocess_planes_plain(raw: torch.Tensor,
                            g: PlaneGeometry) -> torch.Tensor:
    """Plain torch version of :func:`preprocess_planes`: ``preprocess``
    written in torch (unpack, colour transform at full resolution, then
    selection and edge padding as one clamped gather per plane)."""
    chans = apply_pair(_unpack_plain(raw, g), g.xf.tolist())
    dev = raw.device
    parts = []
    for _, dw, dh, rows_sel, cols_sel, ry, rx, idx in g.comp.tolist():
        rows = torch.clamp(torch.arange(dh, device=dev), max=rows_sel - 1) * ry
        cols = torch.clamp(torch.arange(dw, device=dev), max=cols_sel - 1) * rx
        parts.append(chans[idx][rows][:, cols].reshape(-1))
    return torch.cat(parts).to(torch.uint8)


# ---------------------------------------------------------------------------
# D3: the device postprocessor
# ---------------------------------------------------------------------------

#: columns of :attr:`OutGeometry.comp`
OUT_COLS = 6


@dataclasses.dataclass(frozen=True)
class OutGeometry:
    """The operands of D3 for one plan and output image, on one device."""

    fmt: int                      # PixelFormat of the raw output
    height: int
    width: int
    raw_bytes: int                # bytes of the raw output (``raw_size``)
    total: int                    # bytes of the input planes
    #: (C, OUT_COLS) int32 per input plane: byte offset, data width,
    #: component rows and columns, row and column replication to full
    #: resolution (``ceil(H / rows)``, ``ceil(W / columns)``)
    comp: torch.Tensor
    #: (3, SRC_COLS) int32 per output plane of a planar format: byte
    #: offset, width, height, column and row selection step (zeros
    #: otherwise)
    dst: torch.Tensor
    #: (PAIR_CONSTS,) int32 colour-pair constants, stream colour space to
    #: the output's (``pair_consts``)
    xf: torch.Tensor
    #: the C entry's host words: fmt, height, width, C, ``comp``, each
    #: plane's :func:`magic` of ry and rx (as int32 bits), ``dst``, ``xf``
    host: np.ndarray


def out_geometry(plan: CoderPlan, out_image: ImageParameters,
                 device) -> OutGeometry:
    """D3's operands. Raises ValueError for what ``postprocess`` cannot
    pack either: UYVY or planar output of fewer than 3 components, UYVY
    of odd width above 1, or sizes past 32-bit indexing or past
    :func:`magic_exact` of a replication factor."""
    pf = PixelFormat(out_image.pixel_format)
    H, W = out_image.height, out_image.width
    C = len(plan.components)
    if C < 3 and (pf == PixelFormat.PF_422_U8_P1020 or pf in _PLANAR):
        raise ValueError(f"{pf.name} output needs 3 components, the stream "
                         f"has {C}")
    if pf == PixelFormat.PF_422_U8_P1020 and W % 2 and W > 1:
        raise ValueError("PF_422_U8_P1020 needs an even width (or 1)")
    comp, off = [], 0
    for c in plan.components:
        comp.append((off, c.data_width, c.height, c.width,
                     -(-H // c.height) if c.height else 1,
                     -(-W // c.width) if c.width else 1))
        off += c.data_width * c.data_height
    n = raw_size(out_image)
    if max(off, n, 4 * H * W) >= 1 << 31:
        raise ValueError(f"{W}x{H} output of {n} bytes from {off} bytes of "
                         "planes is out of range")
    if not all(magic_exact(ry, H - 1) and magic_exact(rx, W - 1)
               for *_, ry, rx in comp):
        raise ValueError(f"{W}x{H} output replicates its planes out of "
                         "range")
    dst = _planar_inputs(out_image) if pf in _PLANAR \
        else [(0,) * SRC_COLS] * 3
    xf = pair_consts(plan.params.color_space_internal, out_image.color_space,
                     C)
    magics = np.array([magic(d) for *_, ry, rx in comp for d in (ry, rx)],
                      np.uint32).view(np.int32)
    host = np.concatenate([
        np.array([int(pf), H, W, C] + [v for row in comp for v in row],
                 np.int32), magics,
        np.array([v for row in dst for v in row] + list(xf), np.int32)])
    return OutGeometry(
        fmt=int(pf), height=H, width=W, raw_bytes=n, total=off,
        comp=_i32(comp, device), dst=_i32(dst, device), xf=_i32(xf, device),
        host=host)


def _check_d3(planes: torch.Tensor, g: OutGeometry) -> None:
    if planes.dtype != torch.uint8 or tuple(planes.shape) != (g.total,):
        raise ValueError(f"planes must be ({g.total},) uint8, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    C = g.comp.shape[0]
    for name, t, shape in (("comp", g.comp, (C, OUT_COLS)),
                           ("dst", g.dst, (3, SRC_COLS)),
                           ("xf", g.xf, (PAIR_CONSTS,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (planes, g.comp, g.dst, g.xf):
        if t.device != planes.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if not 1 <= C <= 4:
        raise ValueError(f"{C} planes are out of range")
    if planes.device.type == "cuda" and planes.data_ptr() % 8:
        raise ValueError("planes must be 8-byte aligned on the card")


def postprocess_planes(planes: torch.Tensor, g: OutGeometry) -> torch.Tensor:
    """(g.total,) uint8 MCU-padded component planes (D2p's output, E0's
    layout) -> (g.raw_bytes,) uint8 raw frame in the output's pixel
    format and colour space: ``postprocess`` of the planes."""
    _check_d3(planes, g)
    if planes.device.type == "cpu":
        return postprocess_planes_plain(planes, g)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    out = torch.empty((g.raw_bytes,), dtype=torch.uint8, device=planes.device)
    _build.launch(
        "gj_postprocess_planes", planes.device, planes.data_ptr(),
        g.host.ctypes.data, out.data_ptr())
    postprocess_planes.launches += 1
    return out


postprocess_planes.launches = 0


def postprocess_planes_plain(planes: torch.Tensor,
                             g: OutGeometry) -> torch.Tensor:
    """Plain torch version of :func:`postprocess_planes`: ``postprocess``
    written in torch (crop, replication, ``apply_pair``, ``pack_raw``)."""
    H, W = g.height, g.width
    chans = []
    for off, dw, h, w, ry, rx in g.comp.tolist():
        plane = planes[off:off + h * dw].view(h, dw)[:, :w].to(torch.int32)
        chans.append(plane.repeat_interleave(ry, dim=0)
                     .repeat_interleave(rx, dim=1)[:H, :W])
    chans = apply_pair(chans, g.xf.tolist())
    pf, dev = PixelFormat(g.fmt), planes.device
    if pf == PixelFormat.U8:
        return chans[0].to(torch.uint8).reshape(-1)
    if pf == PixelFormat.PF_422_U8_P1020:
        y, u, v = chans[:3]
        out = torch.empty((H, 2 * W), dtype=torch.uint8, device=dev)
        out[:, 1::2] = y
        out[:, 0::4] = u[:, ::2]
        out[:, 2::4] = v[:, ::2]
        return out.reshape(-1)
    if pf in _PLANAR:
        parts = []
        for ch, (_, cw, rows, rx, ry) in zip(chans, g.dst.tolist()):
            r = torch.clamp(torch.arange(rows, device=dev) * ry, max=H - 1)
            c = torch.clamp(torch.arange(cw, device=dev) * rx, max=W - 1)
            parts.append(ch[r][:, c].reshape(-1))
        return torch.cat(parts).to(torch.uint8)
    # interleaved 4:4:4: the channels pack_raw takes, the rest filled
    n = 4 if pf == PixelFormat.PF_444_U8_P012A and len(chans) >= 4 else 3
    fill = 255 if pf == PixelFormat.PF_444_U8_P012A and n == 3 else 0
    step = 3 if pf == PixelFormat.PF_444_U8_P012 else 4
    out = torch.full((H, W, step), fill, dtype=torch.uint8, device=dev)
    for c, ch in enumerate(chans[:n]):
        out[..., c] = ch
    return out.reshape(-1)
