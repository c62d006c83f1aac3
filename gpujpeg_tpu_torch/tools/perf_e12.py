"""E12 ``dct_huffman_blocks`` at 8K, whole and cut, on the card: where
its time goes, and how it compares with the split pair E1p + E2.

    python -m gpujpeg_tpu_torch.tools.perf_e12 [kernel] [cut]
        [--device cuda|cpu] [--height H] [--width W] [--reps N]

The cells:

* (i) ``perf_stage1``'s inputs: random pixel pairs, W = 4 words a block,
  every string cut (the walk's worst case);
* (ii) the main path's frame (``tools.bench_frame``, RGB 4:4:4, Q75,
  non-interleaved, restart interval 32) through E0's planes: E12 with
  ``cap_words = BLOCK_CAP_WORDS`` on the scan-order blocks gathered
  beforehand, beside E1p + E2 (and E2 alone) on the same planes;
* (iii) each stop mode on ``ablate_stage1``'s inputs.

The stages:

* ``kernel``: each call timed by the plain CUDA events and with its runs
  held (``mean_ms(hold=True)``). Run from another tree's root (its
  package, this file copied in), it times that tree's E12: how a
  redesign is timed against its parent on the same card, in turns;
* ``cut``: E12 (``full``) on (i) and (ii) from copies of
  ``dct_huffman_blocks.cu`` and the headers it includes with one of
  :data:`CUT_EDITS` applied, built with ``_build.NVCC_FLAGS`` and called
  through the C entry, held, in turns with the tree's kernel (tree, cuts,
  cuts reversed, tree). ``no_loads`` makes each strip's pixels and side
  data from its index in registers (no loads from device memory);
  ``no_place`` keeps the walk's lengths and bits but places no field and
  stores no word of a string; ``no_walk`` cuts the walk (the loads, E1's
  passes, the stores of the zeroed rows and of the bits stay). Their
  outputs are not E12's. It needs the card and nvcc.

With ``--device cpu`` the ``kernel`` stage times the plain versions
(host clock); the ``cut`` stage raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np
import torch

from .. import _build
from ..ops import dct, entropy
from ..ops.pipeline import EncContext
from ..ops.preprocess import preprocess_planes, upload_raw
from ..params import ImageParameters, Parameters
from ..plan import make_plan
from ..runtime import kernel_build_dir, verify_private_dir
from ..tables import encode_tables
from ..types import ColorSpace, PixelFormat
from . import (ablate_stage1, bench_frame, device, mean_ms, parse_args,
               perf_stage1, report)

STAGES = ("kernel", "cut")
#: (name, text, replacement) on ``dct_huffman_blocks.cu``
CUT_EDITS = (
    ("no_loads",
     """               ? load_row(blocks + (s * kTB + b) * 64 + r * 8, vec)
               : make_uint2(0u, 0u);""",
     """               ? make_uint2((uint32_t)s * 2654435761u + tid,
                            (uint32_t)s * 40503u ^ tid)
               : make_uint2(0u, 0u);"""),
    ("no_loads",
     "               ? make_int4(diff[i], cls[i], valid[i], qsel[i])",
     "               ? make_int4((int)(i & 255) - 128, (int)(i & 1), 1,\n"
     "                           (int)(i & 1))"),
    ("no_place",
     "        if (STOP == kFull && f.total <= 64) {  // warp-uniform",
     "        if (STOP == kFull && cap_words > 0) {\n"
     "          if (lane == 0 && f.total < 0) words[i] = f.off_a;\n"
     "        } else if (STOP == kFull && f.total <= 64) {"),
    ("no_walk",
     "      for (int bb = warp; bb < n; bb += kWarps) {\n"
     "        if (!s_valid[bb]) {  // warp-uniform: no string",
     "      for (int bb = warp; bb < n && cap_words < 0; bb += kWarps) {\n"
     "        if (!s_valid[bb]) {  // warp-uniform: no string"),
)
CUT_SOURCES = ("dct_huffman_blocks.cu", "block_walk.cuh", "dct8.cuh",
               "warp_bits.cuh")
QUALITY, RESTART_INTERVAL = 75, 32


def cut_library(cut: str) -> ctypes.CDLL:
    """E12 with the :data:`CUT_EDITS` of ``cut`` applied, built into the
    kernel build directory (named by a digest of the edited sources)."""
    texts = {}
    for name in CUT_SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            texts[name] = f.read()
    src = CUT_SOURCES[0]
    for name, old, new in CUT_EDITS:
        if name != cut:
            continue
        if texts[src].count(old) != 1:
            raise RuntimeError(f"cut edit {name} not found once in {src}: "
                               f"{old!r}")
        texts[src] = texts[src].replace(old, new)
    digest = hashlib.sha256("".join(texts.values()).encode()).hexdigest()
    if not verify_private_dir(kernel_build_dir()):
        raise RuntimeError(f"kernel build dir {kernel_build_dir()} is not "
                           "private")
    out = os.path.join(kernel_build_dir(), f"e12_{cut}_{digest[:16]}")
    so = os.path.join(out, "gj_e12_cut.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        for name, text in texts.items():
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
        _build.compile_library([os.path.join(out, src)], so)
    return _build.bind(ctypes.CDLL(so), ("gj_dct_huffman_blocks",))


def _call_cut(lib, args: tuple, cap_words: int):
    blocks, diff, cls, valid, qsel, qdiv, _, bias, ac, dc = args
    NB = blocks.shape[0]
    words = torch.empty((NB, cap_words), dtype=torch.int32,
                        device=blocks.device)
    bits = torch.empty((NB,), dtype=torch.int32, device=blocks.device)
    _build.launch(
        "gj_dct_huffman_blocks", blocks.device, blocks.data_ptr(), NB,
        diff.data_ptr(), cls.data_ptr(), valid.data_ptr(), qsel.data_ptr(),
        qdiv.data_ptr(), bias.data_ptr(), ac.data_ptr(), dc.data_ptr(),
        cap_words, entropy.STOP_MODES.index("full"), words.data_ptr(),
        bits.data_ptr(), lib=lib)


def main_path(height: int, width: int, dev):
    """(E12's operands at cap BLOCK_CAP_WORDS without the cap, E1p's
    operands, E2's operands) on the main path's frame: E0's planes, their
    scan-order blocks, each block's DC difference from E1p's
    coefficients."""
    image = ImageParameters(width=width, height=height,
                            color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=QUALITY, restart_interval=RESTART_INTERVAL)
    plan = make_plan(params, image)
    ctx = EncContext(plan, *encode_tables(params.quality), dev)
    t, g, geo = ctx.tables, ctx.planes, ctx.geo
    planes = preprocess_planes(upload_raw(
        bench_frame(height, width).reshape(-1), image, dev), g)
    e1p = (planes, t.dct, t.bias, ctx.qdiv, g.blk, g.block_plane_idx)
    coeff = dct.fdct_quant_planes(*e1p)
    blocks, comp = dct.scan_order_blocks(planes, g.blk, g.block_plane_idx)
    dc = coeff[:, 0].long()
    pred = geo.dc_pred.long()
    diff = (dc - torch.where(pred < 0, 0, dc[pred.clamp(min=0)])).int()
    e12 = (blocks, diff, geo.block_cls, torch.ones_like(diff),
           comp.to(torch.int32), ctx.qdiv, t.dct, t.bias, t.ac512, t.dc64)
    e2 = (coeff, geo.dc_pred, geo.block_cls, t.ac512, t.dc64)
    return e12, e1p, e2


def run(stages, dev, height: int, width: int, reps: int = 20) -> list[dict]:
    """Time E12 on the cells; one row per call and stage."""
    dev = torch.device(dev)
    if "cut" in stages and dev.type != "cuda":
        raise RuntimeError("the cut stage needs the card")
    e12 = entropy.dct_huffman_blocks
    inp = perf_stage1.make_inputs(["stage1"], height, width, dev)
    W = inp.geo.words_per_block
    a_i = perf_stage1.e12_args(inp, W)[:10]
    a_ii, e1p, e2 = main_path(height, width, dev)
    cap = entropy.BLOCK_CAP_WORDS
    rows = []

    def timed(stage, kernel, fn):
        held = dev.type == "cuda"
        ms, clock = mean_ms(fn, dev, reps)
        row = {"stage": stage, "kernel": kernel, "ms": ms, "clock": clock}
        if held:
            row["ms_held"] = mean_ms(fn, dev, reps, hold=True)[0]
        rows.append(row)

    if "kernel" in stages:
        timed("kernel", "(i) dct_huffman_blocks", lambda: e12(*a_i, W))
        timed("kernel", "(ii) dct_huffman_blocks",
              lambda: e12(*a_ii, cap))
        timed("kernel", "(ii) fdct_quant_planes + huffman_blocks",
              lambda: entropy.huffman_blocks(dct.fdct_quant_planes(*e1p),
                                             *e2[1:]))
        timed("kernel", "(ii) huffman_blocks",
              lambda: entropy.huffman_blocks(*e2))
        ab, Wa = ablate_stage1.make_inputs(height, width, dev)
        for m in entropy.STOP_MODES:
            timed("kernel", f"(iii) dct_huffman_blocks[{m}]",
                  lambda m=m: e12(*ab, Wa, m))
        del ab
    if "cut" in stages:
        cuts = sorted({name for name, _, _ in CUT_EDITS})
        libs = {c: cut_library(c) for c in cuts}
        for cell, args, cw in (("(i)", a_i, W), ("(ii)", a_ii, cap)):
            calls = {"whole": lambda: e12(*args, cw)}
            calls.update({c: (lambda lib=libs[c]: _call_cut(lib, args, cw))
                          for c in cuts})
            order = list(calls) + list(calls)[::-1]
            ms = {c: [] for c in calls}
            for c in order:
                ms[c].append(mean_ms(calls[c], dev, reps, hold=True)[0])
            for c, runs in ms.items():
                rows.append({"stage": "cut", "kernel": f"{cell} {c}",
                             "ms": float(np.mean(runs)),
                             "clock": "CUDA events, held"})
    return rows


def main(argv: list | None = None) -> list[dict]:
    args = parse_args(__doc__.splitlines()[0], STAGES, argv)
    dev = device(args.device)
    print(f"perf_e12 {args.width}x{args.height} on {args.device}",
          flush=True)
    rows = run(args.stages, dev, args.height, args.width, args.reps)
    report("perf_e12", rows)
    return rows


if __name__ == "__main__":
    main()
