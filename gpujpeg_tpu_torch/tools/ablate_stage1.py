"""E12 cut after each stage at 8K, on the card: the port's counterpart
of the JAX package's ``scripts/ablate_stage1.py``.

    python -m gpujpeg_tpu_torch.tools.ablate_stage1 [io] [passthru]
        [dctonly] [dct] [dctmul] [synth] [lookups] [full]
        [--device cuda|cpu] [--height H] [--width W]

Each mode is one instantiation of ``csrc/dct_huffman_blocks.cu`` (its
``stop`` argument) and writes what the script's mode of the same name
writes (the source's header): ``io`` loads and stores only,
``passthru`` writes pixels, ``dctonly`` the DCT with no divisor, ``dct``
the quotients, ``dctmul`` multiplies by the divisor in place of the
division, ``synth`` stops after the categories and value bits,
``lookups`` walks with symbol codes from arithmetic in place of the
tables, ``full`` is E12. The inputs are the script's: its geometry
(``perf_stage1.stage1_plan``), pixel pairs and DC differences drawn
from ``np.random.default_rng(0)``, padded to its tile of 768 blocks with
invalid blocks.

The script's other modes time TPU formulations with no stage of their
own in E12: ``scans`` (the lane prefix scan of its 128-lane rows; E12's
warp scan is part of its walk), ``windows`` (the shift-OR window
trees), ``wmm`` (window assembly on the MXU) and ``dctfast`` (bf16 MXU
passes; the port keeps float32 without TF32).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import entropy
from ..tables import device_tables
from . import HEIGHT, WIDTH, device, mean_ms, parse_args, report
from .perf_stage1 import pair_tables, stage1_plan

#: the script's stage-1 tile (blocks), to which its inputs are padded
TILE = 768


def make_inputs(height: int = HEIGHT, width: int = WIDTH, dev="cpu"):
    """(E12's operands as tensors on ``dev`` without ``cap_words`` and
    ``stop``, W): the script's arrays (``ablate_stage1.py:278-319``)
    through ``entropy.from_pair_rows``."""
    plan, quant_zz, huff, geo = stage1_plan(height, width)
    M = geo.n_rows // 2
    Mp = -(-M // (TILE // 2)) * (TILE // 2)
    _, _, q2tab = pair_tables(quant_zz)
    rng = np.random.default_rng(0)
    pb2 = rng.integers(0, 255, (Mp, 128)).astype(np.uint8)
    diff2 = rng.integers(-200, 200, (Mp, 2)).astype(np.int32)
    cls2 = np.zeros((Mp, 2), np.int32)
    cls2[:M] = np.asarray(geo.block_cls).reshape(-1, 2)
    valid2 = np.zeros((Mp, 2), np.int32)
    valid2[:M] = np.asarray(geo.block_valid).reshape(-1, 2)
    qidx = (cls2[:, 0] * 2 + cls2[:, 1])[:, None]
    e = {k: torch.as_tensor(v, device=dev) for k, v in entropy.from_pair_rows(
        pb2, diff2, cls2, valid2, qidx, q2tab).items()}
    t = device_tables(quant_zz, huff, dev)
    return ((e["blocks"], e["diff"], e["block_cls"], e["valid"], e["qsel"],
             e["qdiv"], t.dct, t.bias, t.ac512, t.dc64),
            geo.words_per_block)


def run(args: tuple, W: int, modes, dev, reps: int = 20) -> list[dict]:
    """Time E12 in each of ``modes`` with ``cap_words = W``."""
    dev = torch.device(dev)
    ctas, threads = entropy.dct_huffman_grid(args[0].shape[0])
    rows = []
    for mode in modes:
        ms, clock = mean_ms(
            lambda: entropy.dct_huffman_blocks(*args, W, mode), dev, reps)
        rows.append({"stage": mode, "kernel": f"dct_huffman_blocks[{mode}]",
                     "ms": ms, "clock": clock, "blocks": args[0].shape[0],
                     "W": W, "launch": f"{ctas}x{threads}"})
    return rows


def main(argv: list | None = None) -> list[dict]:
    args = parse_args(__doc__.splitlines()[0], entropy.STOP_MODES, argv)
    dev = device(args.device)
    e12, W = make_inputs(args.height, args.width, dev)
    print(f"ablate_stage1 {args.width}x{args.height} on {args.device}: "
          f"{e12[0].shape[0]} blocks (tile {TILE}), W={W}", flush=True)
    rows = run(e12, W, args.stages, dev, args.reps)
    report("ablate_stage1", rows)
    return rows


if __name__ == "__main__":
    main()
