"""E0 and D3 on the 8K cells, whole and with the colour transform cut,
on the card: where their time goes.

    python -m gpujpeg_tpu_torch.tools.perf_pixels [kernel] [cut]
        [--device cuda|cpu] [--height H] [--width W] [--reps N]

The cells (chip_smoke.py's; bytes from ``np.random.default_rng(0)``:
neither kernel's work depends on the values):

* E0 ``preprocess_planes`` on (a) I420 BT.709 in, YCbCr 4:2:0
  interleaved; (c) RGB in, 4:2:0 non-interleaved; S3, perf_rgbpack's RGB
  4:4:4 non-interleaved plan;
* D3 ``postprocess_planes`` on (a)'s planes to I420 BT.709, (c)'s to
  RGB, and (e)'s RGB 4:4:4 planes to RGB.

The stages:

* ``kernel``: each kernel checked equal to its plain version, then timed
  with its runs held (``mean_ms(hold=True)``), beside its bound (each
  input byte read once and each output byte written once, at 3.35 TB/s);
* ``cut``: the same calls on a copy of ``preprocess.cu``,
  ``postprocess.cu`` and ``pixel_io.cuh`` with the colour transform cut
  (:data:`CUT_EDITS`: each transformed byte becomes an exclusive or of
  the pixel's channels, so the loads stay live), built with
  ``_build.NVCC_FLAGS`` and called through the C entries: loads,
  unpacking, selection and stores. Its time against ``kernel``'s is what
  the transform costs. It needs the card and nvcc.

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
from ..ops.preprocess import (
    out_geometry, plane_geometry, postprocess_planes,
    postprocess_planes_plain, preprocess_planes, preprocess_planes_plain)
from ..params import ImageParameters, Parameters
from ..plan import make_plan
from ..runtime import kernel_build_dir, verify_private_dir
from ..types import ColorSpace, PixelFormat
from . import device, mean_ms, parse_args, report
from .perf_stage1 import stage1_plan

STAGES = ("kernel", "cut")
#: bytes a second of the card's memory (data sheet, H100 SXM)
PEAK_BYTES_S = 3.35e12
#: (source, text, replacement): the colour transform cut out of E0 and D3
CUT_EDITS = (
    ("preprocess.cu",
     "    return finish<XF>(x, k, part<XF>(x, k, v[1], v[2]), v[0]);",
     "    return v[0] ^ v[1] ^ v[2];"),
    ("preprocess.cu",
     "            o[j] = finish<XF>(a.xf, k, pt, v[0][j]);",
     "            o[j] = v[0][j] ^ v[1][j] ^ v[2][j];"),
    ("postprocess.cu",
     "    finish<XF>(a.xf, pt, v[0], all, v);",
     "    v[0] ^= v[1] ^ v[2];"),
    ("postprocess.cu",
     "    finish<XF>(a.xf, part<XF>(a.xf, v[1], v[2]), v[0], true, v);",
     "    v[0] ^= v[1] ^ v[2];"),
)
CUT_SOURCES = ("preprocess.cu", "postprocess.cu", "pixel_io.cuh")


def cells(height: int, width: int, dev) -> tuple[list, list]:
    """([(name, raw, PlaneGeometry)] of E0, [(name, planes, OutGeometry)]
    of D3) at ``height`` x ``width`` on ``dev``."""
    rng = np.random.default_rng(0)
    i420 = ImageParameters(width=width, height=height,
                           color_space=ColorSpace.YCBCR_BT709,
                           pixel_format=PixelFormat.PF_420_U8_P0P1P2)
    rgb = ImageParameters(width=width, height=height,
                          color_space=ColorSpace.RGB,
                          pixel_format=PixelFormat.PF_444_U8_P012)
    a = make_plan(Parameters(restart_interval=4, interleaved=True)
                  .with_chroma_subsampling(420), i420)
    c = make_plan(Parameters(restart_interval=32)
                  .with_chroma_subsampling(420), rgb)
    e = make_plan(Parameters(quality=100, restart_interval=64), rgb)

    def draw(n):
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(
            dev)
    e0 = []
    for name, plan in (("(a)", a), ("(c)", c),
                       ("S3", stage1_plan(height, width)[0])):
        g = plane_geometry(plan, dev)
        e0.append((name, draw(g.raw_bytes), g))
    d3 = []
    for name, plan, out in (("(a)", a, i420), ("(c)", c, rgb),
                            ("(e)", e, rgb)):
        g = out_geometry(plan, out, dev)
        d3.append((name, draw(g.total), g))
    return e0, d3


def cut_library() -> ctypes.CDLL:
    """E0 and D3 with :data:`CUT_EDITS` applied, built into the kernel
    build directory (named by a digest of the edited sources)."""
    texts = {}
    for name in CUT_SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            texts[name] = f.read()
    for name, old, new in CUT_EDITS:
        if old not in texts[name]:
            raise RuntimeError(f"cut edit not found in {name}: {old!r}")
        texts[name] = texts[name].replace(old, new)
    digest = hashlib.sha256("".join(texts.values()).encode()).hexdigest()
    if not verify_private_dir(kernel_build_dir()):
        raise RuntimeError(f"kernel build dir {kernel_build_dir()} is not "
                           "private")
    out = os.path.join(kernel_build_dir(), f"cut_{digest[:16]}")
    so = os.path.join(out, "gj_cut.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        for name, text in texts.items():
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
        _build.compile_library([os.path.join(out, n) for n in CUT_SOURCES
                                if n.endswith(".cu")], so)
    return _build.bind(ctypes.CDLL(so), ("gj_preprocess_planes",
                                         "gj_postprocess_planes"))


def _e0_cut(lib, raw, g, out):
    _build.launch("gj_preprocess_planes", raw.device, raw.data_ptr(),
                  g.host.ctypes.data, g.bands.data_ptr(),
                  g.bands.shape[0] - 1, out.data_ptr(), lib=lib)


def _d3_cut(lib, planes, g, out):
    _build.launch("gj_postprocess_planes", planes.device, planes.data_ptr(),
                  g.host.ctypes.data, out.data_ptr(), lib=lib)


def run(stages, dev, height: int, width: int, reps: int = 20) -> list[dict]:
    """Check and time E0 and D3 on the cells; one row per kernel, cell
    and stage."""
    dev = torch.device(dev)
    if "cut" in stages and dev.type != "cuda":
        raise RuntimeError("the cut stage needs the card")
    e0, d3 = cells(height, width, dev)
    lib = cut_library() if "cut" in stages else None
    calls = []   # (kernel, cell, whole, plain, cut, bytes moved)
    for name, raw, g in e0:
        out = torch.empty(g.total, dtype=torch.uint8, device=dev)
        calls.append(("preprocess_planes", name,
                      lambda raw=raw, g=g: preprocess_planes(raw, g),
                      lambda raw=raw, g=g: preprocess_planes_plain(raw, g),
                      lambda raw=raw, g=g, out=out: _e0_cut(lib, raw, g, out),
                      raw.numel() + g.total))
    for name, planes, g in d3:
        out = torch.empty(g.raw_bytes, dtype=torch.uint8, device=dev)
        calls.append(("postprocess_planes", name,
                      lambda p=planes, g=g: postprocess_planes(p, g),
                      lambda p=planes, g=g: postprocess_planes_plain(p, g),
                      lambda p=planes, g=g, out=out: _d3_cut(lib, p, g, out),
                      planes.numel() + g.raw_bytes))
    rows = []
    for stage in stages:
        for kernel, cell, whole, plain, cut, nbytes in calls:
            if stage == "kernel" and not torch.equal(whole(), plain()):
                raise RuntimeError(f"{kernel} {cell} differs from its plain "
                                   "version")
            ms, clock = mean_ms(whole if stage == "kernel" else cut, dev,
                                reps, hold=True)
            bound_ms = nbytes / PEAK_BYTES_S * 1e3
            row = {"stage": stage, "kernel": f"{kernel} {cell}", "ms": ms,
                   "clock": clock, "bound_ms": bound_ms}
            if dev.type == "cuda":
                row["share_of_bound"] = bound_ms / ms
            rows.append(row)
    return rows


def main(argv: list | None = None) -> list[dict]:
    args = parse_args(__doc__.splitlines()[0], STAGES, argv)
    dev = device(args.device)
    print(f"perf_pixels {args.width}x{args.height} on {args.device}",
          flush=True)
    rows = run(args.stages, dev, args.height, args.width, args.reps)
    report("perf_pixels", rows)
    return rows


if __name__ == "__main__":
    main()
