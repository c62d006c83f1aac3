"""The encode's stage-1 kernels in isolation at 8K, on the card: the
port's counterpart of the JAX package's ``scripts/perf_stage1.py``.

    python -m gpujpeg_tpu_torch.tools.perf_stage1 [copy] [stage1] [merge]
        [--device cuda|cpu] [--height H] [--width W] [--reps N]

The geometry is the script's: RGB 4:4:4, Q75, restart interval 32, the
JAX package's tier-1 uniform geometry (:func:`build_uniform_geometry`;
at 8K 1,555,200 blocks, W = 4 words a block).
The stages:

* ``copy``: ``copy_bytes`` (``csrc/copy_bytes.cu``, the counterpart of
  the script's "null" kernel) on the script's ``(N/2, 128)`` u8 array,
  beside ``Tensor.clone()`` of it (timed in turns; on a card also with
  the runs held, ``mean_ms(hold=True)``), with the achieved rate;
* ``stage1``: E12 ``dct_huffman_blocks`` with ``cap_words = W`` on the
  script's pair-row inputs (``from_pair_rows``), the counterpart of K12;
* ``merge``: E2 then E3 on the script's random coefficients in scan
  order (one line: E3 does the merge and the stuffing that the script
  times apart).

The script's TPU tile sweeps (null tiles 256-4096, stage-1 tiles
512-2048, ``seg_tile``, stuff tiles) measured Mosaic's cost per grid
step and have no counterpart; each line gives its kernel's launch
configuration.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..ops import entropy
from ..ops.huffman_encode import build_enc_geometry, cap_for_quality
from ..params import ImageParameters, Parameters
from ..plan import CoderPlan, make_plan
from ..tables import (DeviceTables, dct_zigzag_operator, device_tables,
                      encode_tables)
from ..types import ColorSpace, PixelFormat
from . import HEIGHT, WIDTH, device, mean_ms, parse_args, report

STAGES = ("copy", "stage1", "merge")
QUALITY, RESTART_INTERVAL = 75, 32
#: copy_bytes: threads per CTA and bytes per CTA (``csrc/copy_bytes.cu``)
COPY_THREADS, COPY_CHUNK = 256, 8192


# ---------------------------------------------------------------------------
# S1: copy_bytes
# ---------------------------------------------------------------------------

def copy_bytes(x: torch.Tensor) -> torch.Tensor:
    """A new tensor holding the bytes of the contiguous ``x``: on the
    card the kernel of ``csrc/copy_bytes.cu``, on the CPU
    :func:`copy_bytes_plain`."""
    if not x.is_contiguous():
        raise ValueError("copy_bytes needs a contiguous tensor")
    if x.device.type == "cpu":
        return copy_bytes_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    _build.launch("gj_copy_bytes", x.device, x.data_ptr(), out.data_ptr(),
                  x.numel() * x.element_size())
    copy_bytes.launches += 1
    return out


copy_bytes.launches = 0


def copy_bytes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`copy_bytes`: ``x.clone()``."""
    return x.clone()


def copy_grid(n_bytes: int) -> tuple[int, int]:
    """(CTAs, threads) of one ``copy_bytes`` launch: a CTA a chunk, none
    for 0 bytes. On the card :func:`run` holds it to
    :func:`copy_launch`."""
    return -(-n_bytes // COPY_CHUNK), COPY_THREADS


def copy_launch(n_bytes: int) -> tuple[int, int]:
    """(CTAs, threads) that ``gj_copy_bytes`` launches for ``n_bytes``,
    from the built kernel library (``gj_copy_bytes_grid``)."""
    ctas, threads = ctypes.c_longlong(), ctypes.c_int()
    _build.query("gj_copy_bytes_grid", n_bytes, ctypes.byref(ctas),
                 ctypes.byref(threads))
    return ctas.value, threads.value


# ---------------------------------------------------------------------------
# The script's geometry and inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UniformGeometry:
    """The fields of the JAX package's stage-1 geometry
    (``entropy_v2.UniformGeometry``) that size the scripts' inputs: every
    segment padded to ``bps`` (a power of two) blocks."""

    bps: int
    n_rows: int                 # segments * bps
    #: (n_rows,) scan-order block of each row; n_blocks on padded rows
    coeff_idx: np.ndarray
    block_cls: np.ndarray       # (n_rows,) 0 luma / 1 chroma
    block_valid: np.ndarray     # (n_rows,) 0 on padded rows
    words_per_block: int        # W
    cap_seg_words: int          # merged string capacity (words)


def block_byte_budget(quality: int) -> int:
    """The JAX package's tier-1 per-block string capacity in bytes
    (``entropy_v2.block_byte_budget``)."""
    if quality >= 98:
        return 224
    if quality >= 80:
        return 32
    return 16


def seg_budget_for_quality(quality: int, bps: int) -> int:
    """The JAX package's tier-1 per-segment byte budget
    (``entropy_v2.seg_budget_for_quality``)."""
    if quality >= 98:
        return bps * 96
    if quality >= 90:
        return bps * 40
    if quality >= 80:
        return bps * 20
    if quality >= 50:
        return bps * 14
    return bps * 10


def build_uniform_geometry(plan: CoderPlan,
                           cap_bytes_per_block: int | None = None,
                           seg_byte_budget: int | None = None
                           ) -> UniformGeometry:
    """``entropy_v2.build_uniform_geometry`` of the JAX package, in NumPy,
    for the fields above."""
    if cap_bytes_per_block is None:
        cap_bytes_per_block = cap_for_quality(plan.params.quality)
    bps = 1
    while bps < int(plan.max_seg_block_count):
        bps <<= 1
    n_rows = plan.n_segments * bps
    coeff_idx = np.full(n_rows, plan.n_blocks, np.int32)
    cls = np.zeros(n_rows, np.int32)
    valid = np.zeros(n_rows, np.int32)
    counts = plan.seg_block_count
    rows = np.arange(n_rows)
    seg, k = rows // bps, rows % bps
    real = k < counts[seg]
    b = plan.seg_block_start[seg] + np.minimum(k, np.maximum(counts[seg] - 1,
                                                             0))
    coeff_idx[real] = b[real]
    cls[real] = build_enc_geometry(plan, cap_bytes_per_block).block_cls[
        b[real]]
    valid[real] = 1
    W = max(2, (cap_bytes_per_block + 3) // 4)
    if seg_byte_budget is not None:
        cap_seg_words = max(W, -(-seg_byte_budget // 4))
    else:
        cap_seg_words = (int(plan.max_seg_block_count) *
                         cap_bytes_per_block + 3) // 4
    cap_seg_words = -(-cap_seg_words // 4) * 4 + 2
    return UniformGeometry(bps=bps, n_rows=n_rows, coeff_idx=coeff_idx,
                           block_cls=cls, block_valid=valid,
                           words_per_block=W, cap_seg_words=cap_seg_words)


def stage1_plan(height: int, width: int, quality: int = QUALITY,
                restart_interval: int = RESTART_INTERVAL):
    """(plan, quant_zz, huff, tier-1 uniform geometry) of the scripts'
    RGB 4:4:4 non-interleaved frame (``perf_stage1.py:46-57``)."""
    params = Parameters(quality=quality, restart_interval=restart_interval)
    image = ImageParameters(width=width, height=height,
                            color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    plan = make_plan(params, image)
    quant_zz, huff = encode_tables(params.quality)
    probe = build_uniform_geometry(plan)
    budget = seg_budget_for_quality(quality, probe.bps)
    geo = build_uniform_geometry(
        plan, cap_bytes_per_block=block_byte_budget(quality),
        seg_byte_budget=min(budget, probe.cap_seg_words * 4))
    return plan, quant_zz, huff, geo


def pair_tables(quant_zz: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(D2 (128, 128), bias2 (128,), q2tab (n_q², 128)) float32: K12's
    block-diagonal DCT, bias and divisor pairs (``perf_stage1.py:
    101-115``)."""
    D64, bias64 = dct_zigzag_operator()
    n_q = 2
    qdiv = np.ones((n_q, 64), np.float32)
    for qi in range(n_q):
        if qi in quant_zz:
            qdiv[qi] = np.maximum(np.asarray(quant_zz[qi], np.float32), 1.0)
    D2 = np.zeros((128, 128), np.float32)
    D2[:64, :64] = D64
    D2[64:, 64:] = D64
    bias2 = np.concatenate([bias64, bias64]).astype(np.float32)
    q2tab = np.stack([np.concatenate([qdiv[i], qdiv[j]])
                      for i in range(n_q) for j in range(n_q)]
                     ).astype(np.float32)
    return D2, bias2, q2tab


@dataclasses.dataclass
class Stage1Inputs:
    """The script's arrays (NumPy) and the E12 operands on one device."""

    plan: CoderPlan
    geo: UniformGeometry
    tables: DeviceTables
    coeff: np.ndarray              # (N, 64) int32 random coefficients
    copy_src: np.ndarray | None    # (N/2, 128) uint8, the null stage's
    pairs: dict | None             # K12's operands: pb2, diff2, cls2, ...
    e12: dict | None               # E12's operands as tensors


def make_inputs(stages, height: int = HEIGHT, width: int = WIDTH,
                dev="cpu", quality: int = QUALITY) -> Stage1Inputs:
    """The script's inputs for ``stages``, drawn from
    ``np.random.default_rng(0)`` in its order (coefficients, then the
    null stage's array, then the pixel pairs), so that they equal the
    JAX script's for the same stages (and quality)."""
    dev = torch.device(dev)
    plan, quant_zz, huff, geo = stage1_plan(height, width, quality)
    N = geo.n_rows
    rng = np.random.default_rng(0)
    coeff = (rng.integers(-40, 40, (N, 64)) *
             (rng.random((N, 64)) < 0.15)).astype(np.int32)
    coeff[:, 0] = rng.integers(-200, 200, N)
    copy_src = pairs = e12 = None
    if "copy" in stages:
        copy_src = rng.integers(0, 255, (N // 2, 128)).astype(np.uint8)
    if "stage1" in stages:
        _, _, q2tab = pair_tables(quant_zz)
        cls_h = np.asarray(geo.block_cls).reshape(-1, 2)
        pairs = {"pb2": rng.integers(0, 255, (N // 2, 128)).astype(np.uint8),
                 "diff2": coeff[:, 0].reshape(-1, 2),
                 "cls2": cls_h,
                 "valid2": np.asarray(geo.block_valid).reshape(-1, 2),
                 "qidx": (cls_h[:, 0] * 2 + cls_h[:, 1])[:, None],
                 "q2tab": q2tab}
        e12 = {k: torch.as_tensor(v, device=dev)
               for k, v in entropy.from_pair_rows(**pairs).items()}
    return Stage1Inputs(plan, geo, device_tables(quant_zz, huff, dev), coeff,
                        copy_src, pairs, e12)


def e12_args(inp: Stage1Inputs, cap_words: int, stop: str = "full") -> tuple:
    """The arguments of :func:`entropy.dct_huffman_blocks` on the
    script's pair rows."""
    e, t = inp.e12, inp.tables
    return (e["blocks"], e["diff"], e["block_cls"], e["valid"], e["qsel"],
            e["qdiv"], t.dct, t.bias, t.ac512, t.dc64, cap_words, stop)


def merge_args(inp: Stage1Inputs, dev) -> tuple:
    """(E2's arguments, E3's segment geometry) on the script's random
    coefficients, placed in scan order."""
    plan, geo = inp.plan, inp.geo
    real = geo.coeff_idx < plan.n_blocks
    coeff = np.zeros((plan.n_blocks, 64), np.int32)
    coeff[geo.coeff_idx[real]] = inp.coeff[real]
    g = entropy.build_seg_geometry(plan, dev)
    t = inp.tables
    return ((torch.as_tensor(coeff, device=dev), g.dc_pred, g.block_cls,
             t.ac512, t.dc64), g)


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

def run(inp: Stage1Inputs, stages, dev, reps: int = 20) -> list[dict]:
    """Run and time ``stages`` on ``inp``; one row per stage."""
    dev = torch.device(dev)
    rows = []
    if "copy" in stages:
        x = torch.as_tensor(inp.copy_src, device=dev)
        n = x.numel()
        r = {"stage": "copy", "kernel": "copy_bytes"}
        # in turns (clone, copy, copy, clone), so that neither gains from
        # its place after the input's upload; on a card also with the runs
        # held (mean_ms), which leaves out the first launch's host time
        for key, hold in ((("", False), ("_held", True))
                          if dev.type == "cuda" else (("", False),)):
            clone_a, _ = mean_ms(lambda: x.clone(), dev, reps, hold)
            ms_a, r["clock"] = mean_ms(lambda: copy_bytes(x), dev, reps, hold)
            ms_b, _ = mean_ms(lambda: copy_bytes(x), dev, reps, hold)
            clone_b, _ = mean_ms(lambda: x.clone(), dev, reps, hold)
            r["ms" + key] = (ms_a + ms_b) / 2
            r["clone_ms" + key] = (clone_a + clone_b) / 2
        if not torch.equal(copy_bytes(x), x):
            raise RuntimeError("copy_bytes did not copy its input")
        ctas, threads = copy_grid(n)
        if dev.type == "cuda" and copy_launch(n) != (ctas, threads):
            raise RuntimeError(f"copy_grid({n}) = {(ctas, threads)}, but "
                               f"gj_copy_bytes launches {copy_launch(n)}")
        r.update(bytes=n, launch=f"{ctas}x{threads}")
        if dev.type == "cuda":
            r["TB_per_s"] = 2 * n / (r["ms"] * 1e9)
        rows.append(r)
    if "stage1" in stages:
        W = inp.geo.words_per_block
        args = e12_args(inp, W)
        words, bits = entropy.dct_huffman_blocks(*args)
        ms, clock = mean_ms(lambda: entropy.dct_huffman_blocks(*args), dev,
                            reps)
        ctas, threads = entropy.dct_huffman_grid(words.shape[0])
        rows.append({"stage": "stage1", "kernel": "dct_huffman_blocks",
                     "ms": ms, "clock": clock, "blocks": words.shape[0],
                     "W": W, "cut": int((bits > 32 * W).sum()),
                     "launch": f"{ctas}x{threads}"})
    if "merge" in stages:
        e2, g = merge_args(inp, dev)

        def merge():
            words, bits = entropy.huffman_blocks(*e2)
            return entropy.merge_stuff(words, bits, g.seg_start, g.seg_count,
                                       g.rst, g.has_rst, g.cap_out)
        out_len = merge()[1]
        ms, clock = mean_ms(merge, dev, reps)
        rows.append({"stage": "merge", "kernel": "huffman_blocks + "
                     "merge_stuff", "ms": ms, "clock": clock,
                     "segments": g.seg_start.shape[0],
                     "bytes_out": int(out_len.sum())})
    return rows


def main(argv: list | None = None) -> list[dict]:
    args = parse_args(__doc__.splitlines()[0], STAGES, argv)
    dev = device(args.device)
    inp = make_inputs(args.stages, args.height, args.width, dev)
    print(f"perf_stage1 {args.width}x{args.height} on {args.device}: "
          f"n_blocks={inp.plan.n_blocks} n_segments={inp.plan.n_segments} "
          f"bps={inp.geo.bps} W={inp.geo.words_per_block}", flush=True)
    rows = run(inp, args.stages, dev, args.reps)
    report("perf_stage1", rows)
    return rows


if __name__ == "__main__":
    main()
