"""E1, E1p, D2 and D2p: the dense stages of the device encode and decode.

**E1**: colour transform + blockify + DCT + quantisation of interleaved
RGB. :func:`fdct_quant` is the wrapper of the hand-written CUDA kernel
``csrc/fdct_quant.cu`` (it replaces stages 1-2 of the JAX reference's
``entropy_v2.encode_dct_fused_full``, K1, and the XLA words front end
before it). :func:`fdct_quant_plain` is its plain torch version; the
wrapper takes it only for tensors on the CPU.

Both compute ``rint((x @ D - bias) / q)`` in float32 with
``D, bias = tables.dct_zigzag_operator()`` and ``q = max(quant, 1)``, the
arithmetic of the reference's ``_stage1_dct_tile``. Division is IEEE
round-to-nearest and rounding is half-to-even. The plain version
multiplies by the dense ``D``; the kernel evaluates the same product in
separable form, a row pass and a column pass with ``D``'s 8x8 factor
(``tables.dct8_matrix`` in float32, compiled into the kernel) on the raw
pixels, then the zig-zag gather and the bias; it reads no ``dct``
operand, so ``dct`` must be ``tables.dct_zigzag_operator()``'s, as every
caller's is. Either differs from the float64 value by less than
``2**-17 * (x @ |D| + |bias|)``, so a quotient can differ by one between
them (and between either and the JAX package) only where its float64
value lies within twice that bound, over the divisor, of .5.

**E1p**: blockify + DCT + quantisation of the component planes that E0
(``ops/preprocess.py``) writes, for every plan. :func:`fdct_quant_planes`
wraps ``csrc/fdct_quant_planes.cu``: E1's separable form and arithmetic
over scan-order blocks, each read from its plane through
``plan.block_plane_idx`` (it replaces the DCT+quant of the JAX
reference's ``block_chunks_dct_fused``, K6, and the staged path's XLA
blockify, gather and DCT matmul, ``jax_pipeline.py:209-243``); like E1
it reads no ``dct`` operand, which must be
``tables.dct_zigzag_operator()``'s. :func:`fdct_quant_planes_plain` is
its plain torch version (the dense operator, as E1's). On 4:4:4 RGB
input, E1p on E0's planes equals E1 bit for bit.

**D2**: dequantisation + IDCT + inverse colour transform + unblockify.
:func:`idct_rgb` wraps ``csrc/idct_rgb.cu`` (it replaces the fused
dequant+IDCT tail of ``pallas_decode_v3.run_pixels``, K2, the
``pallas_decode.unblockify_bands`` kernel, K3, and the XLA
``rgbpack.interleave_raw_words`` after them); :func:`idct_rgb_plain` is
its plain torch version. Both compute ``clip(rint(x @ Wq + 128), 0,
255)`` in float32 per component, with ``Wq`` the component's
``tables.idct_operator_f32``, then the exact integer inverse transform
(``rgbpack.planes_to_rgb``). Both take the zig-zag quant tables
``quant``. The plain version builds the dense ``Wq`` from them and
multiplies by it (the JAX package's ``dequant_idct_device``); the
kernel dequantises by ``quant`` and runs E1's
separable form backwards (a column pass and a row pass with
``tables.dct8_matrix`` in float32). Either lies within ``2**-17 *
(|x| @ |Wq| + 128)`` of the float64 value, so a value can round apart
between them only where its float64 value lies within twice that
bound of .5; a pixel there can differ.

**D2p**: dequantisation + IDCT + unblockify into the component planes,
for every plan. :func:`idct_planes` wraps ``csrc/idct_planes.cu``: D2's
separable form and arithmetic over scan-order blocks, each written to
its plane through ``plan.block_plane_idx`` (it replaces the JAX
reference's plan tail after K4 or K5: the scan -> plane gather,
``dequant_idct_device`` and ``blocks_to_plane``,
``jax_pipeline.py:1147-1184``). Like D2 it takes the zig-zag tables
``quant``. Its output is E0's layout, which D3
(``ops/preprocess.py:postprocess_planes``) packs. :func:`idct_planes_plain`
is its plain torch version (the dense operators built from ``quant``, as
D2's). On 4:4:4 input, D2p followed by D3 to RGB equals D2 bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..tables import idct_dequant_matrix
from .blocks import blocks_to_plane, plane_to_blocks
from .entropy import _check as check_operands
from .rgbpack import planes_to_rgb, rgb_to_planes


def _check(rgb, dct, bias, qdiv, xf):
    if rgb.dtype != torch.uint8 or rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be (H, W, 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    H, W, _ = rgb.shape
    if H % 8 or W % 8 or H == 0 or W == 0:
        raise ValueError(f"image {W}x{H} is not a whole number of blocks")
    for name, t, shape, dtype in (("dct", dct, (64, 64), torch.float32),
                                  ("bias", bias, (64,), torch.float32),
                                  ("qdiv", qdiv, (3, 64), torch.float32),
                                  ("xf", xf, (13,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (rgb, dct, bias, qdiv, xf):
        if t.device != rgb.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def fdct_quant(rgb: torch.Tensor, dct: torch.Tensor, bias: torch.Tensor,
               qdiv: torch.Tensor, xf: torch.Tensor,
               interleaved: bool) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (3*H/8*W/8, 64) int32 zig-zag coefficients
    in scan order (component-major, or Y/Cb/Cr per block position when
    ``interleaved``). ``qdiv`` holds each component's divisor row, ``xf``
    the transform constants (``rgbpack.transform_consts_tensor``)."""
    _check(rgb, dct, bias, qdiv, xf)
    if rgb.device.type == "cpu":
        return fdct_quant_plain(rgb, dct, bias, qdiv, xf, interleaved)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    H, W, _ = rgb.shape
    out = torch.empty((3 * (H // 8) * (W // 8), 64), dtype=torch.int32,
                      device=rgb.device)
    _build.launch(
        "gj_fdct_quant", rgb.device, rgb.data_ptr(), H, W, bias.data_ptr(),
        qdiv.data_ptr(), xf.data_ptr(), int(bool(interleaved)),
        out.data_ptr())
    fdct_quant.launches += 1
    return out


fdct_quant.launches = 0


def fdct_quant_plain(rgb: torch.Tensor, dct: torch.Tensor, bias: torch.Tensor,
                     qdiv: torch.Tensor, xf: torch.Tensor,
                     interleaved: bool) -> torch.Tensor:
    """Plain torch version of :func:`fdct_quant` (a float32 matmul; on a
    CUDA tensor the caller keeps TF32 off)."""
    vals = xf.tolist()
    consts = (None, None) if vals[12] else (vals[:9], vals[9:12])
    planes = rgb_to_planes(rgb, consts)                     # (3, H, W)
    _, H, W = planes.shape
    blocks = (planes.reshape(3, H // 8, 8, W // 8, 8)
              .permute(0, 1, 3, 2, 4)
              .reshape(3, -1, 64))
    coeff = quantize_plain(fdct_blocks_plain(blocks, dct, bias),
                           qdiv[:, None, :])
    if interleaved:
        coeff = coeff.permute(1, 0, 2)
    return coeff.reshape(-1, 64).contiguous()


def _check_planes(planes, dct, bias, qdiv, blk, block_plane_idx):
    C = blk.shape[0] if blk.dim() == 2 else 0
    if not 1 <= C <= 4:
        raise ValueError(f"blk must hold 1..4 planes, got {tuple(blk.shape)}")
    if planes.dim() != 1 or planes.numel() % 64 \
            or planes.numel() >= 1 << 31:
        raise ValueError(f"planes must be flat whole blocks of fewer than "
                         f"2**31 bytes, got {tuple(planes.shape)}")
    check_operands({"planes": (planes, planes.shape, torch.uint8),
                    "dct": (dct, (64, 64), torch.float32),
                    "bias": (bias, (64,), torch.float32),
                    "qdiv": (qdiv, (C, 64), torch.float32),
                    "blk": (blk, (C, 4), torch.int32),
                    "block_plane_idx": (block_plane_idx,
                                        (planes.numel() // 64,),
                                        torch.int32)}, planes.device)


def fdct_quant_planes(planes: torch.Tensor, dct: torch.Tensor,
                      bias: torch.Tensor, qdiv: torch.Tensor,
                      blk: torch.Tensor,
                      block_plane_idx: torch.Tensor) -> torch.Tensor:
    """(P,) uint8 component planes (E0's output) -> (P/64, 64) int32
    zig-zag coefficients in scan order: row i is the plane block
    ``block_plane_idx[i]``, divided by the divisor row ``qdiv[c]`` of its
    plane c. ``blk`` holds per plane (byte offset, data width, first plane
    block, blocks per row), planes in plane-block order. ``dct`` must be
    ``tables.dct_zigzag_operator()``'s: the kernel compiles its 8x8
    factor in and reads no ``dct``."""
    _check_planes(planes, dct, bias, qdiv, blk, block_plane_idx)
    if planes.device.type == "cpu":
        return fdct_quant_planes_plain(planes, dct, bias, qdiv, blk,
                                       block_plane_idx)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    NB = block_plane_idx.shape[0]
    out = torch.empty((NB, 64), dtype=torch.int32, device=planes.device)
    _build.launch(
        "gj_fdct_quant_planes", planes.device, planes.data_ptr(),
        block_plane_idx.data_ptr(), NB, blk.data_ptr(), blk.shape[0],
        qdiv.data_ptr(), bias.data_ptr(), out.data_ptr())
    fdct_quant_planes.launches += 1
    return out


fdct_quant_planes.launches = 0


def fdct_quant_planes_plain(planes: torch.Tensor, dct: torch.Tensor,
                            bias: torch.Tensor, qdiv: torch.Tensor,
                            blk: torch.Tensor,
                            block_plane_idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`fdct_quant_planes`: blockify each
    plane, gather the blocks in scan order, a float32 matmul (on a CUDA
    tensor the caller keeps TF32 off)."""
    blocks, comp = scan_order_blocks(planes, blk, block_plane_idx)
    return quantize_plain(fdct_blocks_plain(blocks, dct, bias), qdiv[comp])


def scan_order_blocks(planes: torch.Tensor, blk: torch.Tensor,
                      block_plane_idx: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """E0's planes -> (blocks (NB, 64) uint8 in scan order, pixels
    row-major, each block's plane index (NB,) int64), by the operands of
    :func:`fdct_quant_planes`."""
    rows = blk.tolist()
    ends = [r[0] for r in rows[1:]] + [planes.numel()]
    blocks = torch.cat([
        plane_to_blocks(planes[off:end].view(-1, dw))
        for (off, dw, _, _), end in zip(rows, ends)])
    first = torch.tensor([r[2] for r in rows], device=planes.device)
    idx = block_plane_idx.to(torch.int64)
    comp = torch.searchsorted(first, idx, right=True) - 1
    return blocks[idx].contiguous(), comp


def fdct_blocks_plain(blocks: torch.Tensor, dct: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """(..., 64) pixels -> float32 ``x @ dct - bias`` (zig-zag DCT of the
    level-shifted block; on a CUDA tensor the caller keeps TF32 off)."""
    return torch.matmul(blocks.to(torch.float32), dct) - bias


def quantize_plain(y: torch.Tensor, qdiv: torch.Tensor) -> torch.Tensor:
    """float32 DCT values -> int32 ``rint(y / qdiv)`` (half to even)."""
    return torch.round(y / qdiv).to(torch.int32)


def _check_idct(coeff, quant, q_of, xf, H, W):
    if H % 8 or W % 8 or H <= 0 or W <= 0:
        raise ValueError(f"image {W}x{H} is not a whole number of blocks")
    n_q = quant.shape[0] if quant.dim() == 2 else 0
    if not 1 <= n_q <= 3:
        raise ValueError(f"quant must hold 1..3 tables, got "
                         f"{tuple(quant.shape)}")
    check_operands({"coeff": (coeff, (3 * (H // 8) * (W // 8), 64),
                              torch.int32),
                    "quant": (quant, (n_q, 64), torch.float32),
                    "q_of": (q_of, (3,), torch.int32),
                    "xf": (xf, (13,), torch.int32)}, coeff.device)


def idct_rgb(coeff: torch.Tensor, quant: torch.Tensor, q_of: torch.Tensor,
             xf: torch.Tensor, interleaved: bool, H: int,
             W: int) -> torch.Tensor:
    """(3*H/8*W/8, 64) int32 zig-zag coefficients in scan order (the
    orders E1 writes) -> (H, W, 3) uint8 raw pixels. ``quant`` holds the
    unique zig-zag quant tables, ``q_of`` each component's index into
    them (values below ``quant.shape[0]``), ``xf`` the inverse-transform
    constants (``rgbpack.transform_consts_tensor``). On the card
    ``coeff`` must start on a 16-byte boundary."""
    _check_idct(coeff, quant, q_of, xf, H, W)
    if coeff.device.type == "cpu":
        return idct_rgb_plain(coeff, quant, q_of, xf, interleaved, H, W)
    if coeff.device.type != "cuda":
        raise ValueError(f"unsupported device {coeff.device}")
    if coeff.data_ptr() % 16:
        raise ValueError("coeff must start on a 16-byte boundary")
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=coeff.device)
    _build.launch(
        "gj_idct_rgb", coeff.device, coeff.data_ptr(), H, W,
        quant.data_ptr(), quant.shape[0], q_of.data_ptr(), xf.data_ptr(),
        int(bool(interleaved)), out.data_ptr())
    idct_rgb.launches += 1
    return out


idct_rgb.launches = 0


def idct_rgb_plain(coeff: torch.Tensor, quant: torch.Tensor,
                   q_of: torch.Tensor, xf: torch.Tensor, interleaved: bool,
                   H: int, W: int) -> torch.Tensor:
    """Plain torch version of :func:`idct_rgb`: a float32 matmul by the
    dense operators of ``quant`` (the float64 unit operator scaled by each
    table, rounded once: ``tables.idct_operator_f32``; on a CUDA tensor
    the caller keeps TF32 off)."""
    wq = dense_operators(quant)
    nblk = (H // 8) * (W // 8)
    x = coeff.to(torch.float32)
    x = x.view(nblk, 3, 64).permute(1, 0, 2) if interleaved \
        else x.view(3, nblk, 64)
    y = torch.matmul(x, wq[q_of.to(torch.int64)]) + 128.0
    px = torch.clamp(torch.round(y), 0, 255).to(torch.int32)
    planes = (px.view(3, H // 8, W // 8, 8, 8).permute(0, 1, 3, 2, 4)
              .reshape(3, H, W))
    vals = xf.tolist()
    return planes_to_rgb(planes, (None, None) if vals[12]
                         else (vals[:9], vals[9:12]))


def dense_operators(quant: torch.Tensor) -> torch.Tensor:
    """(n_q, 64) zig-zag quant tables -> (n_q, 64, 64) float32 IDCT
    operators: the float64 unit operator scaled by each table, rounded
    once (``tables.idct_operator_f32``, ``DecodeTables.wq``)."""
    unit = torch.from_numpy(idct_dequant_matrix(np.ones(64))).to(quant.device)
    return (unit * quant.to(torch.float64)[:, :, None]).to(torch.float32)


def _check_idct_planes(coeff, quant, q_of, blk, block_plane_idx, total):
    C = blk.shape[0] if blk.dim() == 2 else 0
    if not 1 <= C <= 4:
        raise ValueError(f"blk must hold 1..4 planes, got {tuple(blk.shape)}")
    n_q = quant.shape[0] if quant.dim() == 2 else 0
    if not 1 <= n_q <= 4:
        raise ValueError(f"quant must hold 1..4 tables, got "
                         f"{tuple(quant.shape)}")
    if not 0 < total < 1 << 31 or total % 64:
        raise ValueError(f"planes of {total} bytes are out of range")
    check_operands({"coeff": (coeff, (total // 64, 64), torch.int32),
                    "quant": (quant, (n_q, 64), torch.float32),
                    "q_of": (q_of, (C,), torch.int32),
                    "blk": (blk, (C, 4), torch.int32),
                    "block_plane_idx": (block_plane_idx, (total // 64,),
                                        torch.int32)}, coeff.device)


def idct_planes(coeff: torch.Tensor, quant: torch.Tensor,
                q_of: torch.Tensor, blk: torch.Tensor,
                block_plane_idx: torch.Tensor, total: int) -> torch.Tensor:
    """(NB, 64) int32 zig-zag coefficients in scan order (D1's output) ->
    (total,) uint8 MCU-padded component planes, concatenated in component
    order, each (data_height, data_width) row-major (E0's layout). Row i
    is the plane block ``block_plane_idx[i]``, dequantised by the zig-zag
    table ``quant[q_of[c]]`` of its plane c. ``blk`` holds per plane (byte
    offset, data width, first plane block, blocks per row), planes in
    plane-block order (``preprocess.block_geometry``). On the card
    ``coeff`` must start on a 16-byte boundary."""
    _check_idct_planes(coeff, quant, q_of, blk, block_plane_idx, total)
    if coeff.device.type == "cpu":
        return idct_planes_plain(coeff, quant, q_of, blk, block_plane_idx,
                                 total)
    if coeff.device.type != "cuda":
        raise ValueError(f"unsupported device {coeff.device}")
    if coeff.data_ptr() % 16:
        raise ValueError("coeff must start on a 16-byte boundary")
    out = torch.empty((total,), dtype=torch.uint8, device=coeff.device)
    _build.launch(
        "gj_idct_planes", coeff.device, coeff.data_ptr(), coeff.shape[0],
        quant.data_ptr(), quant.shape[0], q_of.data_ptr(), blk.data_ptr(),
        blk.shape[0], block_plane_idx.data_ptr(), out.data_ptr())
    idct_planes.launches += 1
    return out


idct_planes.launches = 0


def idct_planes_plain(coeff: torch.Tensor, quant: torch.Tensor,
                      q_of: torch.Tensor, blk: torch.Tensor,
                      block_plane_idx: torch.Tensor,
                      total: int) -> torch.Tensor:
    """Plain torch version of :func:`idct_planes`: a float32 matmul per
    plane on its scan-order rows by the dense operators of ``quant``
    (:func:`dense_operators`; on a CUDA tensor the caller keeps TF32
    off), round half to even, clamp, then the scatter to plane order and
    the un-blockify."""
    wq = dense_operators(quant)
    rows = blk.tolist()
    idx = block_plane_idx.to(torch.int64)
    first = torch.tensor([r[2] for r in rows], device=coeff.device)
    comp = torch.searchsorted(first, idx, right=True) - 1
    x = coeff.to(torch.float32)
    px = torch.empty(coeff.shape, dtype=torch.uint8, device=coeff.device)
    for c, q in enumerate(q_of.tolist()):
        sel = torch.nonzero(comp == c)[:, 0]
        y = torch.matmul(x[sel], wq[q]) + 128.0
        px[sel] = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    blocks = torch.empty_like(px)
    blocks[idx] = px
    ends = [r[0] for r in rows[1:]] + [total]
    return torch.cat([
        blocks_to_plane(blocks[pb:pb + (end - off) // 64],
                        (end - off) // dw, dw).reshape(-1)
        for (off, dw, pb, _), end in zip(rows, ends)])
