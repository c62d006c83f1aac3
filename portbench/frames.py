"""The benchmark's frames, made on the device from ``--seed``.

The recipe of the bench frame (``tools.bench_frame``, after the JAX
package's ``bench.make_image``), rewritten in torch and frozen here:
three smooth fields plus Gaussian noise of standard deviation 3, clipped
and cut to bytes. The fields are read as the input pixel format's
channels (R, G, B, or Y, Cb, Cr of a YCbCr format; a fourth channel is
255). Frame ``t`` of a pool sees the fields moved left by ``t *
pan_px`` pixels, a pan; every frame draws its own noise. A seed changes
the noise and nothing else, so every seed gives the same sizes and the
same amount of work.
"""
from __future__ import annotations

import torch

from .reference import pixels
from .reference.geometry import PIXEL_FORMATS

#: the recipe's noise (standard deviation, in levels)
NOISE = 3.0


def fields(height: int, width: int, shift: float, noise: torch.Tensor
           ) -> torch.Tensor:
    """(3, H, W) uint8: the three fields at horizontal offset ``shift``
    plus ``noise``."""
    dev = noise.device
    y = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=dev, dtype=torch.float32)[None, :] + shift
    f = torch.stack([
        128 + 90 * torch.sin(x / 23.0) * torch.cos(y / 17.0),
        128 + 80 * torch.cos(x / 31.0 + 1.0) * torch.sin(y / 11.0),
        128 + 70 * torch.sin((x + y) / 41.0),
    ])
    return torch.clamp(f + noise, 0, 255).to(torch.uint8)


def make_pool(cfg: dict, seed: int, device) -> list:
    """``cfg["pool_frames"]`` flat uint8 raw frames of the configuration
    on ``device``, from one generator seeded with ``seed``."""
    H, W = cfg["height"], cfg["width"]
    n_ch = len(PIXEL_FORMATS[cfg["pixel_format"]][2])
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 64)
    pool = []
    for t in range(cfg["pool_frames"]):
        noise = torch.randn((3, H, W), generator=g, device=device) * NOISE
        ch = list(fields(H, W, t * cfg.get("pan_px", 0), noise).to(torch.int32))
        if n_ch == 4:
            ch.append(torch.full_like(ch[0], 255))
        pool.append(pixels.pack(ch[:n_ch], W, H, cfg["pixel_format"])
                    .to(torch.uint8))
        del noise
    return pool
