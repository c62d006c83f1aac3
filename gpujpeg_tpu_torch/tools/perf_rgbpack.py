"""E0 on RGB 4:4:4 input at 8K against the copy of the same bytes, on
the card: the port's counterpart of the JAX package's
``scripts/perf_rgbpack.py``.

    python -m gpujpeg_tpu_torch.tools.perf_rgbpack [pack] [copy]
        [--device cuda|cpu] [--height H] [--width W]

The script timed Pallas bodies (``pk`` with ``body_slice``,
``body_refsl``, ``body_gather``) that turn the raw RGB bytes, viewed as
``(H, 3W/4)`` int32 words, into ``(3H, W/4)`` Y/Cb/Cr plane words by
``rgbpack._shuffle_transform``, each required to equal the XLA
``preprocess`` plus a word pack, against a plain copy of the words
(``copy_i32``). On the card that function is E0 ``preprocess_planes``
for RGB 4:4:4, non-interleaved, Q75, restart interval 32: its planes,
read as little-endian int32, are those words. The stages:

* ``pack``: E0 on the script's frame (``np.random.default_rng(0)``
  pixels, the first five of row 0 white), checked equal to its plain
  version;
* ``copy``: ``copy_bytes`` on the same raw bytes, the copy floor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.preprocess import (
    plane_geometry, preprocess_planes, preprocess_planes_plain, upload_raw)
from . import HEIGHT, WIDTH, device, mean_ms, parse_args, report
from .perf_stage1 import copy_bytes, copy_grid, stage1_plan

STAGES = ("pack", "copy")


def make_frame(height: int = HEIGHT, width: int = WIDTH) -> np.ndarray:
    """The script's (H, W, 3) uint8 frame (``perf_rgbpack.py:63-65``)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    img[0, :5] = 255
    return img


def plane_words(planes: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """E0's planes of an unpadded 4:4:4 frame as ``(3H, W/4)`` int32
    little-endian words (the script's layout)."""
    return planes.view(torch.int32).view(3 * height, width // 4)


def run(img: np.ndarray, stages, dev, reps: int = 20) -> list[dict]:
    """Check and time E0 and the copy on ``img``; one row per stage."""
    dev = torch.device(dev)
    H, W, _ = img.shape
    if H % 8 or W % 8:
        raise ValueError(f"{W}x{H}: the plane words need whole 8x8 blocks")
    plan = stage1_plan(H, W)[0]
    g = plane_geometry(plan, dev)
    raw = upload_raw(img.reshape(-1), plan.image, dev)
    rows = []
    if "pack" in stages:
        words = plane_words(preprocess_planes(raw, g), H, W)
        plain = plane_words(preprocess_planes_plain(raw, g), H, W)
        if not torch.equal(words, plain):
            raise RuntimeError("E0 differs from its plain version")
        ms, clock = mean_ms(lambda: preprocess_planes(raw, g), dev, reps)
        rows.append({"stage": "pack", "kernel": "preprocess_planes",
                     "ms": ms, "clock": clock,
                     "words": f"{tuple(words.shape)} int32",
                     "equal_to_plain": True})
    if "copy" in stages:
        ms, clock = mean_ms(lambda: copy_bytes(raw), dev, reps)
        ctas, threads = copy_grid(raw.numel())
        rows.append({"stage": "copy", "kernel": "copy_bytes", "ms": ms,
                     "clock": clock, "bytes": raw.numel(),
                     "launch": f"{ctas}x{threads}"})
    return rows


def main(argv: list | None = None) -> list[dict]:
    args = parse_args(__doc__.splitlines()[0], STAGES, argv)
    dev = device(args.device)
    print(f"perf_rgbpack {args.width}x{args.height} on {args.device}",
          flush=True)
    rows = run(make_frame(args.height, args.width), args.stages, dev,
               args.reps)
    report("perf_rgbpack", rows)
    return rows


if __name__ == "__main__":
    main()
