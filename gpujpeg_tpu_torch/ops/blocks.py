"""Plane <-> 8x8 block layout conversions (NumPy arrays or torch
tensors: ``swapaxes`` and ``reshape`` mean the same in both)."""
from __future__ import annotations


def plane_to_blocks(plane, xp=None):
    """(H, W) -> (H/8*W/8, 64); blocks in raster order, pixels in natural
    (row-major) order within each block."""
    h, w = plane.shape
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    return (plane.reshape(h // 8, 8, w // 8, 8)
                 .swapaxes(1, 2)
                 .reshape(h // 8 * (w // 8), 64))


def blocks_to_plane(blocks, h: int, w: int, xp=None):
    """(H/8*W/8, 64) -> (H, W)."""
    return (blocks.reshape(h // 8, w // 8, 8, 8)
                  .swapaxes(1, 2)
                  .reshape(h, w))
