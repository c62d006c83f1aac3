"""Run the PyTorch/CUDA port's encode and decode paths on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout. The script needs one CUDA device, the CUDA
toolkit (``nvcc``) and a C++ compiler; it imports nothing of JAX. Its
phases, one line each or more, stop the script with a non-zero exit at
the first failure:

1. the card: ``torch.cuda.is_available()`` and the name and power limit
   that ``nvidia-smi`` reports;
2. the build of the kernels of ``gpujpeg_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a``, timed;
3. each kernel of the encode main path (E1 fdct_quant, E2
   huffman_blocks, E3 merge_stuff) against its plain torch version on
   the card at 8K (7680x4320 RGB 4:4:4, Q75, restart interval 32): E1
   equal except |d| = 1 where the float64 quotient lies within 2 * eps
   of .5 (the per-coefficient tie rule of ``F32_EVALS``; the count is
   printed), E2 and E3 fed the same inputs and bit-exact; E2 also
   bit-exact on E2's envelope blocks (``entropy.envelope_blocks``: runs
   over 15, 63 without EOB, all-zero AC, |v| to 2047) with the Annex K
   tables and with a 16-bit ZRL, E3 on its envelope segments
   (``entropy.envelope_segments``: 1 to 100 blocks, strings of 1 to
   1,792 bits, rows stuffed to the worst case); with both times and the
   bound;
4. ``Encoder(backend="torch", device="cuda").encode`` end to end at that
   size with every kernel's launch count above 0, the stream decoded by
   the port's golden decoder to within 0.1 dB PSNR of the golden
   encoder's stream, and byte-identical to it in every restart segment
   whose coefficients agree with the float64 golden DCT (the others
   differ only at .5 ties, within 1e-4); a 256x256 frame encodes on the
   card and through the plain path on the CPU to streams equal in every
   segment without a tie; first-call and steady-state encode times, the
   device time of E1-E3 by CUDA events, and ``stats.asdict()`` of an
   encode with ``perf_stats`` on;
5. the decode kernels (D0 destuff_rows, D1 huffman_decode, D2 idct_rgb)
   on phase 4's stream against their plain versions: D0's rows equal to
   the host's ``gj_build_rows``' there and on an HD 4:2:0 stream at
   interval 4, where D0 is timed too; D1 bit-exact and equal to the
   native golden decoder, and bit-exact on its corrupt-stream envelope
   (``decode.envelope_rows``) with the Annex K tables and with a 16-bit
   ZRL; D2 (a separable IDCT, its plain version the dense operator) equal
   before the colour transform except |d| = 1 where the float64 value
   lies within 2 * eps of .5 (the per-value tie rule of ``F32_EVALS``;
   the count and the largest distance in eps are printed), its colour
   transform exact;
6. ``Decoder(backend="torch", device="cuda").decode`` end to end against
   the golden decoder (within 1 before the colour transform, 0.01 dB
   PSNR), a 256x256 stream on the card against the CPU plain path, the
   decode's stage times and ``stats.asdict()`` with ``perf_stats`` on;
7. the general encode's kernels at 8K against their plain versions: E0
   preprocess_planes bit-exact and E1p fdct_quant_planes (E1's separable
   form over scan-order blocks) under phase 3's per-coefficient tie rule
   on (a) I420 video in, YCbCr 4:2:0 interleaved, Q75, restart interval
   4 (777,600 blocks in 32,400 segments) and (c) RGB in, 4:2:0
   non-interleaved, Q75, interval 32; E2 and E3 bit-exact on (a)'s
   coefficients; E1p on E0's planes of phase 3's frame equal to E1 bit
   for bit; kernel and plain times on (a), E0's time and bound on (c);
   the sweep: E0 bit-exact against its plain version for every input
   pixel format (1, 3 and 4 components, every step of the colour
   transform) at 8K 4:2:0 interleaved and at 1923x1081 (1924 for UYVY)
   4:2:2 non-interleaved, on bytes from ``np.random.default_rng``, each
   with its time and bound;
8. ``Encoder.encode`` end to end at 8K on (a), (c) and (d) RGB 4:4:4
   Q100 interval 32: each kernel of the route launched once per encode,
   each stream equal to the golden encoder's in every segment without a
   .5 tie and within 0.1 dB of its golden-decoded PSNR; first-call and
   steady times and (a)'s stage breakdown;
9. every colour config (the six of the JAX package's
   tests/test_quality.py, YUV -> BT.601 and RGB -> RGB) at 17x13 and
   200x136, interleaved or not, encoded on the card and through the CPU
   plain path to equal streams (outside .5 ties, within 2 * eps);
10. the general decode's kernels at 8K (D1 huffman_decode, D2p
   idct_planes, D3 postprocess_planes) on the streams of (a), (c) and
   (e) RGB 4:4:4 Q100 interval 64, whose rows exceed 384 words (the JAX
   package's K5 regime; each stream's row width is printed, (d)'s too):
   D1 equal to its plain version and the native golden decoder, D2p
   (D2's separable form over scan-order blocks) equal to its plain
   version under phase 5's per-value tie rule and to the golden float64
   IDCT within 1 eps of .5, D3 bit-exact against its plain version and
   the host ``postprocess``; D2p + D3 equal to D2 bit for bit, before
   and after the colour transform, on the main path's stream and on (e),
   both timed to RGB, D3 alone too; kernel and plain times, D3's time and
   bound on (c); the sweep: D3 bit-exact against its plain version for
   every output pixel format from 1-, 3- and 4-component planes at 8K
   (4:2:0 interleaved) and at 1923x1081 (1924 for UYVY; 4:2:2
   non-interleaved), on bytes from ``np.random.default_rng``, each with
   its time and bound;
11. ``Decoder.decode`` end to end at 8K: (a) to I420 BT.709, (c) to RGB,
   (e) to RGB (D2) and to planar 4:4:4 YCbCr (D2p + D3): the route's
   kernels launched once per decode, the output the host postprocess of
   the card's own planes, those within 1 eps of .5 ties of the golden
   decoder's,
   PSNR within 0.01 dB of the golden decode's; first-call, steady and
   stage times; then ``decode_to_device`` of the main path's stream (to
   RGB) and of (a)'s (to I420), and ``Encoder.encode`` of each CUDA
   frame as it is and as its int32 words, equal to the encode of the
   same bytes from the host, all three timed;
12. every output format x {4:4:4, 4:2:0 interleaved, 4:2:2, gray} x
   {17x13, 200x136} decoded on the card and through the CPU plain path
   (no golden route), equal outside .5 IDCT ties;
13. the stage-1 probe tools (``gpujpeg_tpu_torch/tools/``) at 8K, their
   kernels' launches counted on the tools' own paths: (i) E12
   dct_huffman_blocks (K12) on perf_stage1's inputs (W = 4 words a
   block, every string cut): its ``dct`` values against the plain
   version's under E1's per-value rule (E12's DCT is separable, the
   plain version's the dense operator) and equal to its own quotients
   (E1p's on the same blocks, ``e1p_quotients``), its strings equal to
   the plain walk of those quotients in every block; (ii) E12 + E3
   against E1p -> E2 -> E3 on E0's planes of phase 3's frame, equal in
   every segment, with E12's time beside E1p + E2's and whether fusion
   wins; (iii) each of E12's stop modes on ablate_stage1's inputs, with
   its time: io and passthru equal to the plain version, the value
   modes under the per-value rule, synth, lookups and full (and dct)
   equal to the plain output of E12's own quotients; (iv) copy_bytes byte-exact,
   its rate beside ``Tensor.clone()``'s (timed in turns, by the plain
   events and with the runs held) and the bound, its launch shape that
   of the tool's ``copy_grid``, and byte-exact on every length of
   ``COPY_EDGE_LENGTHS`` from and to every offset of
   ``COPY_EDGE_OFFSETS``, the bytes around the destination untouched;
   (v) E0 on perf_rgbpack's frame equal to its plain version, beside the
   copy; (vi) perf_pixels: E0 and D3 on the 8K cells ((a), (c), S3; (a),
   (c), (e)) checked equal to their plain versions and timed with the
   runs held, whole and with the colour transform cut, beside the bound;
14. the batch and command-line entry points, timed: (i) ``Encoder.warmup``
   of a fresh encoder and its first encode timed; the peak device memory
   (``max_memory_allocated``) of one 8K encode of the main path and of
   (d) within ``Encoder.max_memory``, and ``max_pixels`` of the card;
   (ii) ``Encoder.encode_batch`` of 8 frames of the main path at 8K and
   16 of (a)'s configuration at 4K (3840x2160, interval 4), frames rolled
   from one image: every stream equal to ``encode`` of its frame, each
   kernel of the route launched once a frame, the batch's per-frame time
   beside the loop of ``encode`` (host clock, median of 3); (iii)
   ``Decoder.decode_batch`` of those streams to RGB and to I420, every
   output equal to ``decode`` of its stream, launches once a frame, times
   beside the loop; a mixed batch (8K, 4K, a 200x136 stream without
   restart markers on the lane route, a 40x32 stream of under 32 segments
   on the golden route, 8K) equal to the per-frame decodes; a corrupt stream in the
   middle raises ``JpegParseError`` and a decode after it succeeds;
   ``output_to_device`` through the batch gives CUDA tensors; (iv)
   ``capture_device_call``'s replay of the 8K decode equal to its output;
   (v) ``python -m gpujpeg_tpu_torch`` in subprocesses: ``-L`` names the
   card, ``-e`` of an 8K PPM equals ``Encoder.encode`` of its pixels,
   ``-d`` back equals ``Decoder.decode``, a Y4M of 8 HD frames to a
   ``%d`` pattern (through ``encode_batch``) gives the per-frame
   encodes' files; (vi) ``examples/device_array_roundtrip.py`` and
   ``examples/video_pipeline.py`` at their defaults on ``cuda``;
15. the parallel layer (``gpujpeg_tpu_torch.parallel``), each run with
   the route's launch counts set to 0 before it and each kernel held to
   one launch a band: (i) ``ShardedEncoder`` over a (1, 4) mesh of
   cuda:0 on the main path at 8K (restart interval
   ``choose_restart_interval`` over 4 bands, 32: 4,050 segments a band
   and scan, so every band's markers are the frame's) and over a (1, 2)
   mesh on (a) (1,080 rows a band of 4 would not be whole MCU rows), each
   stream equal to ``Encoder.encode``'s; (ii) ``encode_batch`` of 4
   main-path frames, rolled from one image, over a (2, 2) mesh of cuda:0,
   each equal to ``encode`` of its frame; (iii) ``ShardedDecoder`` of
   (i)'s streams and ``decode_batch`` of (ii)'s over 4 bands, each frame
   equal to ``Decoder.decode``'s; the main path's sharded encode and
   decode timed beside ``Encoder.encode`` and ``Decoder.decode`` (host
   clock, median of 3); (iv) a D1 made to fail in one band raises from
   ``decode`` and ``decode_batch``, a corrupt stream raises
   ``JpegParseError`` from ``decode_batch``, and a decode after them
   succeeds; (v) two ranks in subprocesses (``chip_smoke.py --rank``)
   sharing cuda:0 over gloo: ``MultiHostEncoder`` of one 8K frame a rank,
   ``MultiHostSingleImageEncoder`` of one 8K image over 2 bands a rank,
   ``MultiHostDecoder`` of each rank's stream, each equal to the
   single-process calls here, both ranks' single-image streams equal,
   each rank loading the built kernel library and neither rebuilding it;
   (vi) ``examples/sharded_encode.py`` and ``examples/multihost_video.py``
   at their defaults on ``cuda`` (with (v)'s ranks, four processes at
   once); (vii) with two or more cards, (i) and (iii) again over distinct
   cards, else a line that says only meshes repeating cuda:0 ran;
16. the bench entry points (``gpujpeg_tpu_torch/tools/bench.py`` and
   ``bench_suite.py``): ``python -m gpujpeg_tpu_torch.tools.bench`` in a
   subprocess at a depth of ``BENCH16_ITERS``, exit 0, every key of its
   line, a time in each time key, the route gate's launches and the
   card's name, beside (at the same time, so its times are not
   measurements) the first 16K encode and decode on the card in this
   process, ``bench_suite.bench_res("16K", 3)`` (15360x8640, interval
   32, 194,400 segments) with the launch counts set to 0 before it: E1,
   E2, E3, D1 and D2 launched 5 times each, no other kernel; the first
   encode's peak memory within ``Encoder.max_memory``; the kernels'
   coefficients of the frame against the float64 golden DCT under the
   tie rule and the stream equal to the golden entropy coder's on them;
   ``Decoder.decode`` of the stream to its own colour space within 1 of
   the golden decoder's; the phase timed.
17. the soak on the card (``gpujpeg_tpu_torch/tools/soak.py``, the
   counterpart of ``scripts/soak.py``) with the launch counts set to 0
   before it: the cases of ``SOAK17_FIXED`` in turn, then ``SOAK17_THREADS``
   threads, each with its own coders, on ``SOAK17_THREAD_CASES`` cases
   each; every case's stream held to the CPU route's (equal outside .5
   DCT ties) and to the golden stream's length, its decode to the CPU
   route's (coefficients exact, bytes within 2) and to the golden
   decode's, its truncated and flipped streams decoded (equal to the CPU
   route's or both ``JpegParseError``; a frame over 4x the original
   decodes or raises ``JpegParseError``, ``oom`` counted), every kernel of
   the encode and decode routes launched; the phase's time, cases a second
   and ``oom`` count printed.
18. the lane decoder D1L (``huffman_lanes``) on the 12 MP camera frame
   without restart markers (4032x3024 RGB to 4:2:0 interleaved, Q92,
   interval 0, the port's host coder; :data:`PHOTO`): on the card's rows
   ``ctx.coefficients`` equal to ``huffman_lanes_plain`` on the same rows
   and lane geometry, rounds included, and to D1 (one thread a segment);
   ``decode_to_device`` with the launch counters set to 0 just before it:
   D1L launched once with the geometry's lanes, D1 never, the frame equal
   to ``decode``'s and within 2 of the golden decoder's; the kernel's
   time beside its plain form's and the bound (the scan's bytes read
   once, the coefficients written once at 2 B); then frames of the same
   size where lanes resynchronise late or never (a flat frame and one
   tiling a random 16x16 MCU): equal to D1, their rounds and time
   printed.

The comparison rules (the tie rules, ``card_vs_cpu``, ``decode_parts``)
live in ``gpujpeg_tpu_torch/tools/checks.py``, shared with the soak; a
broken rule raises ``CheckError`` there, and the script ends with
``FAIL``.

The line before the last is a JSON object with every kernel's numbers
(its time, plain time, bound and launches on its path,
``sharded_launches``: its launches in each of phase 15's runs,
``bench16k_launches``: in phase 16's 16K run, and ``soak_launches``: in
phase 17's soak), the line
before it phase 14's batch rows; the last line is ``{"ok": true,
"device": {...}}``. ``chip_smoke.py --rank R PORT DIR LIB`` is phase 15
(v)'s rank process and is not run by hand.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gpujpeg_tpu_torch.models.decoder import plan_from_info
from gpujpeg_tpu_torch.tables import encode_tables
from gpujpeg_tpu_torch.tools.checks import (
    F32_DOT_REL, F32_EVALS, PIXEL_STEP, TIE_EPS, CheckError, card_vs_cpu,
    context, decode_parts, differing_segments, golden_quotients,
    tie_segments)

H8K, W8K, QUALITY = 4320, 7680, 75
PSNR_DB = 0.1
REPLACES = "gpujpeg_tpu/ops/entropy_v2.py:955"
REPLACES_E2 = ("gpujpeg_tpu/ops/entropy_v2.py:955 (stage 1) + "
               "gpujpeg_tpu/ops/entropy_v2.py:856 (stage 1) + "
               "gpujpeg_tpu/ops/entropy_v2.py:572")
REPLACES_E3 = ("gpujpeg_tpu/ops/entropy_v2.py:955 (merge, stuffing, RST) + "
               "gpujpeg_tpu/ops/entropy_v2.py:1512 + "
               "gpujpeg_tpu/ops/entropy_v2.py:1317 + "
               "gpujpeg_tpu/ops/entropy_v2.py:1164 + "
               "gpujpeg_tpu/ops/entropy_v2.py:1603")
DEC_PSNR_DB = 0.01
REPLACES_D0 = "none (the host's gj_build_rows, native/host_codec.cpp)"
REPLACES_D1 = "gpujpeg_tpu/ops/pallas_decode_v3.py:100"
REPLACES_D2 = ("gpujpeg_tpu/ops/pallas_decode_v3.py:596 + "
               "gpujpeg_tpu/ops/pallas_decode.py:238")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_image(H: int, W: int, seed: int = 7) -> np.ndarray:
    """The JAX package's bench frame (``tools.bench_frame``)."""
    from gpujpeg_tpu_torch.tools import bench_frame
    return bench_frame(H, W, seed)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def setup(gj, H: int, W: int):
    from gpujpeg_tpu_torch.plan import make_plan
    image = gj.ImageParameters(width=W, height=H,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)
    ri = gj.suggest_restart_interval(image, subsampled=False,
                                     interleaved=False, pow2=True,
                                     quality=QUALITY)
    params = gj.Parameters(quality=QUALITY, restart_interval=ri)
    return params, image, make_plan(params, image)


def quotient_tie_check(what: str, coeff_a, coeff_b, qdiv, blocks_of) -> int:
    """The per-coefficient tie rule between two float32 evaluations of a
    DCT + quantisation (scan-order coefficients ``coeff_a``,
    ``coeff_b``): they may differ only by 1, and only where the float64
    quotient lies within ``2 * eps`` of .5 (``eps``: golden_quotients'
    bound, one for each evaluation). ``blocks_of(rows)`` gives those
    scan-order rows' (n, 64) pixels and planes, ``qdiv`` the planes'
    divisor rows. Fails otherwise; returns the largest |d|."""
    from gpujpeg_tpu_torch.tables import dct_zigzag_operator
    d = (coeff_a - coeff_b).abs()
    rows, cols = torch.nonzero(d, as_tuple=True)
    n = int(rows.numel())
    if n == 0:
        print(f"{what}: equal in all {coeff_a.numel()} coefficients",
              flush=True)
        return 0
    x, comp = blocks_of(rows)
    x = x.double()
    D64, bias64 = dct_zigzag_operator()
    D = torch.as_tensor(D64, device=x.device)
    bias = torch.as_tensor(bias64, device=x.device)
    q = qdiv.double()[comp, cols]
    y = (x @ D - bias).gather(1, cols[:, None])[:, 0] / q
    eps = F32_DOT_REL * (x @ D.abs() + bias.abs()).gather(
        1, cols[:, None])[:, 0] / q
    far = (y - torch.floor(y) - 0.5).abs()
    worst = float((far / eps).max())
    print(f"{what}: {n} of {coeff_a.numel()} coefficients differ, max |d| "
          f"{int(d.max())}, each within {worst:.3g} eps of a .5 tie "
          f"(allowed {F32_EVALS})", flush=True)
    if int(d.max()) > 1 or worst > F32_EVALS:
        fail(f"{what}: coefficients differ beyond the tie rule")
    return int(d.max())


def e1_tie_check(what: str, ctx, rgb, coeff_a, coeff_b) -> int:
    """:func:`quotient_tie_check` for E1's function on ``rgb``."""
    from gpujpeg_tpu_torch.ops.rgbpack import rgb_to_planes
    vals = ctx.xf.tolist()
    consts = (None, None) if vals[12] else (vals[:9], vals[9:12])
    planes = rgb_to_planes(rgb, consts)
    _, H, W = planes.shape
    nblk = (H // 8) * (W // 8)

    def blocks_of(rows):
        comp, pos = (rows % 3, rows // 3) if ctx.interleaved \
            else (rows // nblk, rows % nblk)
        by, bx = pos // (W // 8), pos % (W // 8)
        iy = (by * 8)[:, None] + torch.arange(8, device=rgb.device)[None, :]
        ix = (bx * 8)[:, None] + torch.arange(8, device=rgb.device)[None, :]
        x = planes[comp[:, None, None], iy[:, :, None], ix[:, None, :]]
        return x.reshape(-1, 64), comp
    return quotient_tie_check(what, coeff_a, coeff_b, ctx.qdiv, blocks_of)


def e1p_tie_check(what: str, ctx, planes: torch.Tensor, coeff_a,
                  coeff_b) -> int:
    """:func:`quotient_tie_check` for E1p's function on E0's
    ``planes``."""
    from gpujpeg_tpu_torch.ops.dct import scan_order_blocks
    g = ctx.planes

    def blocks_of(rows):
        blocks, comp = scan_order_blocks(planes, g.blk, g.block_plane_idx)
        return blocks[rows], comp[rows]
    return quotient_tie_check(what, coeff_a, coeff_b, ctx.qdiv, blocks_of)


def phase_kernels(ctx, rgb) -> list[dict]:
    """Phase 3: each kernel against its plain version on the card."""
    from gpujpeg_tpu_torch.ops import dct, entropy
    t, g = ctx.tables, ctx.geo
    e1 = (rgb, t.dct, t.bias, ctx.qdiv, ctx.xf, ctx.interleaved)
    coeff = dct.fdct_quant(*e1)
    coeff_p = dct.fdct_quant_plain(*e1)
    e1_tie_check("phase 3: E1 fdct_quant vs its plain version", ctx, rgb,
                 coeff, coeff_p)
    err1 = int((coeff - coeff_p).abs().max())

    e2 = (coeff, g.dc_pred, g.block_cls, t.ac512, t.dc64)
    words, bits = entropy.huffman_blocks(*e2)
    words_p, bits_p = entropy.huffman_blocks_plain(*e2)
    used = (torch.arange(words.shape[1], device=words.device)[None, :]
            < ((bits + 31) // 32)[:, None])
    w_bad = int(((words != words_p) & used).sum())
    b_bad = int((bits != bits_p).sum())
    print(f"phase 3: E2 huffman_blocks {b_bad} bit lengths and {w_bad} "
          f"string words differ of {bits.numel()} blocks", flush=True)
    if w_bad or b_bad:
        fail("E2 disagrees with its plain version")
    e2_envelope_check(coeff.device)

    e3 = (words, bits, g.seg_start, g.seg_count, g.rst, g.has_rst, g.cap_out)
    out, out_len, seg_bits, n_ff = entropy.merge_stuff(*e3)
    out_p, out_len_p, seg_bits_p, n_ff_p = entropy.merge_stuff_plain(*e3)
    meta_bad = int(((out_len != out_len_p) | (seg_bits != seg_bits_p)
                    | (n_ff != n_ff_p)).sum())
    valid = (torch.arange(g.cap_out, device=out.device)[None, :]
             < out_len_p[:, None])
    byte_bad = int(((out != out_p) & valid).sum())
    print(f"phase 3: E3 merge_stuff {meta_bad} segment lengths and "
          f"{byte_bad} bytes differ of {out_len.numel()} segments, "
          f"{int(out_len.sum())} bytes", flush=True)
    if meta_bad or byte_bad:
        fail("E3 disagrees with its plain version")
    e3_envelope_check(out.device)

    words_used = used_word_bytes(bits)
    rows = []
    for name, src, repl, kern, plain, args, errv, bnd in (
            ("fdct_quant", "fdct_quant.cu", REPLACES,
             dct.fdct_quant, dct.fdct_quant_plain, e1, err1,
             bound(nbytes(rgb, t.bias, ctx.qdiv, ctx.xf, coeff),
                   coeff.shape[0] * (DCT_BLOCK_FLOPS + COLOUR_BLOCK_FLOPS))),
            ("huffman_blocks", "huffman_blocks.cu", REPLACES_E2,
             entropy.huffman_blocks, entropy.huffman_blocks_plain, e2, 0,
             bound(nbytes(*e2, bits) + words_used)),
            ("merge_stuff", "merge_stuff.cu", REPLACES_E3,
             entropy.merge_stuff, entropy.merge_stuff_plain, e3, 0,
             bound(words_used + nbytes(*e3[1:-1], out_len, seg_bits, n_ff)
                   + int(out_len.sum())))):
        ms = cuda_ms(lambda: kern(*args), 10)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        print(f"phase 3: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})",
              flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"gpujpeg_tpu_torch/csrc/{src}",
                     "replaces": repl, "launches": 0,
                     "max_abs_err": errv, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": None})
    return rows


def e2_envelope_check(device) -> None:
    """E2 against its plain version, bit for bit, on its envelope blocks
    (``entropy.envelope_blocks``, 64 copies along one DC chain) with the
    Annex K tables and with the ZRL given a 16-bit code, luma and
    chroma."""
    from gpujpeg_tpu_torch.ops import entropy
    from gpujpeg_tpu_torch.tables import build_huffman_table
    blocks = np.tile(entropy.envelope_blocks(np.random.default_rng(6)),
                     (64, 1))
    n = blocks.shape[0]
    coeff = torch.from_numpy(blocks).to(device)
    dc_pred = torch.arange(-1, n - 1, dtype=torch.int32, device=device)
    for zrl16 in (False, True):
        huff = {k: build_huffman_table(*v) for k, v in
                entropy.envelope_huffman_spec(zrl16).items()}
        packed = entropy.build_packed_tables(huff)
        ac512 = torch.from_numpy(packed.ac512).to(device)
        dc64 = torch.from_numpy(packed.dc64).to(device)
        for cls in (0, 1):
            e2 = (coeff, dc_pred, torch.full((n,), cls, dtype=torch.int32,
                                             device=device), ac512, dc64)
            words, bits = entropy.huffman_blocks(*e2)
            words_p, bits_p = entropy.huffman_blocks_plain(*e2)
            used = (torch.arange(words.shape[1], device=device)[None, :]
                    < ((bits_p + 31) // 32)[:, None])
            bad = int((bits != bits_p).sum()) \
                + int(((words != words_p) & used).sum())
            if bad:
                fail(f"E2 disagrees with its plain version on the envelope "
                     f"blocks (zrl16={zrl16}, class {cls}): {bad} words "
                     f"and lengths")
    print(f"phase 3: E2 huffman_blocks equal to its plain version on {n} "
          f"envelope blocks x 2 tables x 2 classes (max {int(bits_p.max())} "
          f"bits a block)", flush=True)


def e3_envelope_check(device) -> None:
    """E3 against its plain version, bit for bit, on its envelope segments
    (``entropy.envelope_segments``: 1 to 100 blocks a segment, blocks of
    1 to 1,792 bits, rows stuffed to the worst case, a last segment
    without a marker)."""
    from gpujpeg_tpu_torch.ops import entropy
    env = entropy.envelope_segments(np.random.default_rng(8))
    e3 = (*(torch.from_numpy(a).to(device) for a in env[:6]), env[6])
    out, out_len, seg_bits, n_ff = entropy.merge_stuff(*e3)
    out_p, out_len_p, seg_bits_p, n_ff_p = entropy.merge_stuff_plain(*e3)
    valid = (torch.arange(env[6], device=device)[None, :]
             < out_len_p[:, None])
    bad = int(((out_len != out_len_p) | (seg_bits != seg_bits_p)
               | (n_ff != n_ff_p)).sum()) + int(((out != out_p) & valid).sum())
    if bad:
        fail(f"E3 disagrees with its plain version on the envelope "
             f"segments: {bad} lengths and bytes")
    print(f"phase 3: E3 merge_stuff equal to its plain version on "
          f"{out_len.numel()} envelope segments ({int(e3[3].min())}-"
          f"{int(e3[3].max())} blocks, {int(out_len.sum())} bytes, "
          f"{int(n_ff.sum())} stuffed)", flush=True)


def stage_ms(ctx, raw, quant_zz, huff) -> np.ndarray:
    """Host-clock ms of the encode's stages, each ended by a sync."""
    from gpujpeg_tpu_torch.stream.writer import assemble, scan_bodies

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    plan = ctx.plan
    t = [time.perf_counter()]
    x = ctx.upload(raw)
    sync()
    t.append(time.perf_counter())
    out, out_len, _, _ = ctx.run(x)
    sync()
    t.append(time.perf_counter())
    bodies, sizes = scan_bodies(plan, [ctx.compact(out,
                                                   out_len.cpu().numpy())])
    t.append(time.perf_counter())
    assemble(plan, quant_zz, huff, bodies, sizes)
    t.append(time.perf_counter())
    return np.diff(t) * 1e3


def phase_encode(gj, img, params, image, plan, card: str,
                 device: str = "cuda") -> dict:
    """Phase 4: the public encode end to end, checked against golden."""
    from gpujpeg_tpu_torch.ops import dct, entropy

    kernels = (dct.fdct_quant, entropy.huffman_blocks, entropy.merge_stuff)
    enc = gj.Encoder(backend="torch", device=device)
    raw = img.reshape(-1)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    data = enc.encode(raw, params, image)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches for k in kernels}
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path did not launch: {launches}")

    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        again = enc.encode(raw, params, image)
        steady.append((time.perf_counter() - t0) * 1e3)
    if again != data:
        fail("two encodes of one frame differ")
    ctx = next(iter(enc._contexts.values()))
    quant_zz, huff = encode_tables(params.quality)
    stages = np.median([stage_ms(ctx, raw, quant_zz, huff)
                        for _ in range(3)], axis=0)
    rgb = torch.from_numpy(img).to(device)
    device_ms = cuda_ms(lambda: ctx.run(rgb), 10)

    gold = gj.Encoder(backend="golden").encode(raw, params, image)
    dec = gj.Decoder(backend="golden")
    out_t, _ = dec.decode(data)
    out_g, _ = dec.decode(gold)
    p_t, p_g = psnr(out_t.reshape(img.shape), img), \
        psnr(out_g.reshape(img.shape), img)

    # coefficients: the kernel's against the float64 golden DCT, a tie
    # being a value within TIE_EPS of .5
    y64, _ = golden_quotients(raw, image, plan, quant_zz)
    coeff_k = ctx.coefficients(rgb).cpu().numpy()
    n_ties, tie_segs = tie_segments(plan, coeff_k, np.rint(y64), y64,
                                    "kernel coefficients vs golden")
    del y64
    bad = differing_segments(plan, data, gold, tie_segs)
    print(f"phase 4: encode {image.width}x{image.height} Q{params.quality} ri="
          f"{params.restart_interval}: {len(data)} bytes, launches "
          f"{launches}; PSNR {p_t:.4f} dB vs golden {p_g:.4f} dB; "
          f"{n_ties} coefficients within {TIE_EPS:g} of .5 ties in "
          f"{len(tie_segs)} segments; {len(bad)} of the other "
          f"{plan.n_segments - len(tie_segs)} segments differ from golden",
          flush=True)
    if bad:
        fail(f"segments {bad[:10]} differ from the golden stream")
    if abs(p_t - p_g) > PSNR_DB:
        fail("PSNR differs from the golden stream's by more than 0.1 dB")

    small = make_image(256, 256)
    sp, si, _ = setup(gj, 256, 256)
    s_cuda = enc.encode(small.reshape(-1), sp, si)
    s_cpu = gj.Encoder(backend="torch", device="cpu").encode(
        small.reshape(-1), sp, si)
    s_msg = "equals the CPU plain path's" if s_cuda == s_cpu else \
        card_vs_cpu(small.reshape(-1), sp, si, s_cuda, s_cpu)

    print(f"phase 4: {card}: encode first call {first_ms:.3f} ms, steady "
          f"{float(np.median(steady)):.3f} ms (median of 5, host clock, "
          f"upload and stream assembly included); E1-E3 device "
          f"{device_ms:.4f} ms (CUDA events); 256x256 stream: {s_msg}",
          flush=True)
    print(f"phase 4: {card}: encode stages (host clock, median of 3): "
          f"upload {stages[0]:.3f} ms, E1-E3 {stages[1]:.3f} ms, length "
          f"sync + compaction + D2H {stages[2]:.3f} ms, stream assembly "
          f"{stages[3]:.3f} ms", flush=True)
    print(f"phase 4: {card}: encode stats with perf_stats (ms; kernel "
          f"stages by CUDA events): {perf_stats_encode(gj, raw, params, image)}",
          flush=True)
    return launches, data


def perf_stats_encode(gj, raw, params, image) -> dict:
    """``stats.asdict()`` of a second encode with ``perf_stats`` on (the
    first builds the context), every stage filled."""
    import dataclasses
    p = dataclasses.replace(params, perf_stats=True)
    enc = gj.Encoder(backend="torch", device="cuda")
    first = enc.encode(raw, p, image)
    if enc.encode(raw, p, image) != first:
        fail("two encodes with perf_stats differ")
    st = enc.stats.asdict()
    if min(st[k] for k in ("duration_memory_to", "duration_dct_quantization",
                           "duration_huffman_coder",
                           "duration_memory_from")) <= 0:
        fail(f"perf_stats left an encode stage empty: {st}")
    return st


def cuda_ms_once(fn):
    """(fn(), device ms of that one run by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def rgb_planes(px: torch.Tensor) -> np.ndarray:
    """(H, W, 3) values -> the flat concatenated (H, W) planes of a 4:4:4
    plan, on the host (``plane_ties``' layout)."""
    return px.permute(2, 0, 1).reshape(-1).cpu().numpy()


def d1_envelope_check() -> None:
    """D1 against its plain version, bit for bit, on its corrupt-stream
    envelope (``decode.envelope_rows``: random words, all ones, all
    zeros, blocks that end where k + run passes 63, long codes, rows cut
    short) with the Annex K tables and with the ZRL given a 16-bit
    code."""
    from gpujpeg_tpu_torch.ops import decode
    n = 0
    for zrl16 in (False, True):
        rows, start, count, comp, dec, dcs, acs = decode.envelope_rows(
            np.random.default_rng(11 + zrl16), zrl16, n_seg=8192, wcap=16)
        decode.check_cover(start, count, comp.size)
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            rows, start, count, comp, decode.wide_quick_tables(dec),
            dec.maxcode, dec.delta, dec.huffval, dcs, acs)]
        got = decode.huffman_decode(*args)
        bad = int((got != decode.huffman_decode_plain(*args)).sum())
        n += got.shape[0]
        if bad:
            fail(f"D1 disagrees with its plain version on the envelope rows "
                 f"(zrl16={zrl16}): {bad} coefficients")
    print(f"phase 5: D1 huffman_decode equal to its plain version on {n} "
          f"envelope blocks (2 tables x {n // 2} blocks, rows of 16 words)",
          flush=True)


def phase_decode_kernels(gj, data: bytes, card: str) -> list[dict]:
    """Phase 5: D1 and D2 against their plain versions on the card."""
    from gpujpeg_tpu_torch.native import decode_segments_native
    from gpujpeg_tpu_torch.ops import dct, decode
    from gpujpeg_tpu_torch.ops.rgbpack import (
        planes_to_rgb, transform_consts_tensor)
    info, plan, gold_args, ctx, rows = decode_parts(
        data, out_images(gj)["c"], "cuda")
    t = ctx.tables
    H, W = ctx.shape
    d1 = (rows, ctx.seg_start, ctx.seg_count, ctx.block_comp, t.wide,
          t.maxcode, t.delta, t.huffval, t.dc_slot, t.ac_slot)
    coeff = decode.huffman_decode(*d1)
    coeff_p, d1_plain_ms = cuda_ms_once(lambda: decode.huffman_decode_plain(*d1))
    gold = torch.from_numpy(decode_segments_native(*gold_args)).cuda()
    bad_p = int((coeff != coeff_p).sum())
    bad_g = int((coeff != gold).sum())
    err1 = int((coeff - coeff_p).abs().max())
    print(f"phase 5: D1 huffman_decode {plan.n_segments} segments, "
          f"{plan.n_blocks} blocks, rows {tuple(rows.shape)}: {bad_p} "
          f"coefficients differ from the plain version, {bad_g} from the "
          f"native golden decoder", flush=True)
    if bad_p or bad_g:
        fail("D1 disagrees with its plain version or the golden decoder")
    del coeff_p, gold
    d1_envelope_check()
    d0, d0_bad, hd_row = d0_check(gj, gold_args, rows)

    xf_id = transform_consts_tensor((None, None), "cuda")
    d2_id = (coeff, t.quant, t.q_of, xf_id, ctx.interleaved, H, W)
    px = dct.idct_rgb(*d2_id)
    coeff_h = coeff.cpu().numpy()
    n_diff, err2, _, tie_eps = plane_ties(
        rgb_planes(px), rgb_planes(dct.idct_rgb_plain(*d2_id)), coeff_h, plan,
        info)
    vals = ctx.xf.tolist()
    consts = (None, None) if vals[12] else (vals[:9], vals[9:12])
    d2 = (coeff, t.quant, t.q_of, ctx.xf, ctx.interleaved, H, W)
    rgb = dct.idct_rgb(*d2)
    rgb_own = planes_to_rgb(px.permute(2, 0, 1).int(), consts)
    xf_bad = int((rgb != rgb_own).sum())
    rgb_diff = int((rgb != dct.idct_rgb_plain(*d2)).any(2).sum())
    print(f"phase 5: D2 idct_rgb {n_diff} of {px.numel()} values differ "
          f"from the plain version before the colour transform, max |d| "
          f"{err2}, each within {tie_eps:.3g} eps of a .5 tie (allowed "
          f"{F32_EVALS}); {rgb_diff} RGB pixels differ; {xf_bad} bytes "
          f"differ from the plain transform of the kernel's own values",
          flush=True)
    if err2 > 1 or tie_eps > F32_EVALS:
        fail("D2 disagrees with its plain version beyond .5 ties")
    if xf_bad:
        fail("D2's inverse colour transform is not exact")

    rows_out = []
    for name, src, repl, kern, plain, args, errv, plain_ms, bnd in (
            ("destuff_rows", "destuff_rows.cu", REPLACES_D0,
             decode.destuff_rows, decode.destuff_rows_plain, d0, d0_bad,
             None, bound(nbytes(d0[0], d0[1], rows))),
            ("huffman_decode", "huffman_decode.cu", REPLACES_D1,
             decode.huffman_decode, None, d1, err1, d1_plain_ms,
             bound(nbytes(*d1, coeff))),
            ("idct_rgb", "idct_rgb.cu", REPLACES_D2, dct.idct_rgb,
             dct.idct_rgb_plain, d2, err2, None,
             bound(nbytes(*d2[:4], rgb), coeff.shape[0]
                   * (DCT_BLOCK_FLOPS + COLOUR_BLOCK_FLOPS)))):
        ms = cuda_ms(lambda: kern(*args), 10)
        if plain is not None:
            plain_ms = cuda_ms(lambda: plain(*args), 1)
        print(f"phase 5: {card}: {name} {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})",
              flush=True)
        rows_out.append({"name": name, "route": "cuda",
                         "source": f"gpujpeg_tpu_torch/csrc/{src}",
                         "replaces": repl, "launches": 0,
                         "max_abs_err": errv, "ms": ms,
                         "plain_ms": plain_ms, **bnd, "library_ms": None})
    rows_out[0]["hd"] = hd_row
    return rows_out


def d0_check(gj, gold_args, rows) -> tuple:
    """D0 on phase 4's 8K stream (its scans and ranges uploaded as the
    decode uploads them) against ``gj_build_rows``' ``rows``, and on an HD
    4:2:0 interleaved stream at interval 4 (the HD bench cell's plan),
    timed there with its bound and plain version: (D0's arguments at 8K,
    the words that differ, the HD timing)."""
    from gpujpeg_tpu_torch.ops import decode
    from gpujpeg_tpu_torch.ops.pipeline import upload_scan
    from gpujpeg_tpu_torch.stream.reader import read_image
    dev = torch.device("cuda")
    x = decode.scan_bytes(*gold_args[:3])
    up = upload_scan(x, dev)
    d0 = (up.data, up.ranges, up.wcap)
    bad = int((decode.destuff_rows(*d0) != rows).sum())
    hd = gj.ImageParameters(width=1920, height=1080,
                            color_space=gj.ColorSpace.RGB,
                            pixel_format=gj.PixelFormat.PF_444_U8_P012)
    hp = gj.Parameters(quality=QUALITY, restart_interval=4,
                       interleaved=True) \
        .with_chroma_subsampling(420)
    hd_data = gj.Encoder(backend="torch", device="cuda").encode(
        make_image(1080, 1920).reshape(-1), hp, hd)
    info = read_image(hd_data)
    plan, sd, segs = plan_from_info(info)
    hx = decode.scan_bytes(plan, sd, segs)
    hup = upload_scan(hx, dev)
    h0 = (hup.data, hup.ranges, hup.wcap)
    h_rows = decode.destuff_rows(*h0)
    h_bad = int((h_rows.cpu() != torch.from_numpy(
        decode.build_rows(plan, sd, segs))).sum())
    print(f"phase 5: D0 destuff_rows {x.ranges.shape[1]} segments of "
          f"{x.n_data} scan bytes, rows {tuple(rows.shape)}: {bad} words "
          f"differ from gj_build_rows'; HD {plan.n_segments} segments of "
          f"{hx.n_data} bytes, rows {tuple(h_rows.shape)}: {h_bad}",
          flush=True)
    if bad or h_bad:
        fail("D0 disagrees with gj_build_rows")
    hd_row = {"ms": cuda_ms(lambda: decode.destuff_rows(*h0), 10),
              "plain_ms": cuda_ms(lambda: decode.destuff_rows_plain(*h0), 1),
              **bound(nbytes(hup.data, hup.ranges, h_rows))}
    print(f"phase 5: D0 destuff_rows at HD {hd_row['ms']:.4f} ms, plain "
          f"{hd_row['plain_ms']:.4f} ms, bound {hd_row['bound_ms']:.4f} ms "
          f"({hd_row['bound_by']})", flush=True)
    return d0, bad, hd_row


def dec_stage_ms(dec, data: bytes, out_image) -> np.ndarray:
    """Host-clock ms of a decode's stages, each ended by a sync: parse
    (with the context lookup), row build, upload, kernels, D2H."""
    from gpujpeg_tpu_torch.models.decoder import huffman_maps
    from gpujpeg_tpu_torch.ops.decode import build_rows
    from gpujpeg_tpu_torch.ops.pipeline import dec_context
    from gpujpeg_tpu_torch.stream.reader import read_image
    t = [time.perf_counter()]
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    ctx = dec_context(dec._contexts, plan, info, *huffman_maps(info),
                      out_image, dec.device)
    t.append(time.perf_counter())
    rows = build_rows(plan, scan_data, segs)
    t.append(time.perf_counter())
    rows_d = torch.from_numpy(rows).to(dec.device)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    raw = ctx.run(rows_d)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    raw.cpu().numpy()
    t.append(time.perf_counter())
    return np.diff(t) * 1e3


def phase_decode(gj, img, data: bytes, card: str) -> dict:
    """Phase 6: the public decode end to end, checked against golden."""
    from gpujpeg_tpu_torch.ops import dct, decode
    from gpujpeg_tpu_torch.stream.reader import read_image

    kernels = (decode.destuff_rows, decode.huffman_decode, dct.idct_rgb)
    dec = gj.Decoder(backend="torch", device="cuda")
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    raw, oi = dec.decode(data)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches for k in kernels}
    if min(launches.values()) < 1:
        fail(f"a kernel of the decode path did not launch: {launches}")
    steady = []
    for _ in range(5):
        t0 = time.perf_counter()
        again, _ = dec.decode(data)
        steady.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(again, raw):
        fail("two decodes of one stream differ")
    stats = dec.stats.asdict()
    dev, _ = dec.decode_to_device(data)
    if not (dev.is_cuda and dev.dtype == torch.uint8
            and tuple(dev.shape) == (oi.height * oi.width * 3,)
            and torch.equal(dev.cpu(), torch.from_numpy(raw))):
        fail("decode_to_device differs from the host result")
    del dev

    # before the colour transform (output = the stream's own colour
    # space): within 1 of the float64 golden decoder
    H, W = oi.height, oi.width
    cs = read_image(data).color_space
    outs = {}
    for backend in ("torch", "golden"):
        for name, ocs in (("rgb", gj.ColorSpace.RGB), ("id", cs)):
            dd = gj.Decoder(backend=backend, device="cuda")
            dd.set_output_format(ocs, gj.PixelFormat.PF_444_U8_P012)
            outs[backend, name] = dd.decode(data)[0].reshape(H, W, 3)
    if not np.array_equal(outs["torch", "rgb"], raw.reshape(H, W, 3)):
        fail("the RGB decode differs between two decoders")
    d_id = np.abs(outs["torch", "id"].astype(int) - outs["golden", "id"])
    id_px = d_id.any(axis=2)
    d_rgb = np.abs(outs["torch", "rgb"].astype(int) - outs["golden", "rgb"])
    rgb_px = d_rgb.any(axis=2)
    p_t, p_g = psnr(raw.reshape(img.shape), img), \
        psnr(outs["golden", "rgb"], img)
    print(f"phase 6: decode {W}x{H}: launches {launches}; against the "
          f"golden decoder {int((d_id != 0).sum())} values differ before "
          f"the colour transform (max |d| {int(d_id.max())}), "
          f"{int(rgb_px.sum())} RGB pixels differ (max |d| "
          f"{int(d_rgb.max())}), {int((rgb_px & ~id_px).sum())} of them "
          f"where the values agree; PSNR {p_t:.4f} dB vs golden "
          f"{p_g:.4f} dB", flush=True)
    if d_id.max() > 1:
        fail("the decode differs from golden by more than 1 before the "
             "colour transform")
    if (rgb_px & ~id_px).any():
        fail("an RGB pixel differs where the untransformed values agree")
    if abs(p_t - p_g) > DEC_PSNR_DB:
        fail("PSNR differs from the golden decode's by more than 0.01 dB")

    # a 256x256 stream: the card against the CPU plain path
    small = make_image(256, 256)
    sp, si, _ = setup(gj, 256, 256)
    s_data = gj.Encoder(backend="torch", device="cuda").encode(
        small.reshape(-1), sp, si)
    s_cuda, _ = dec.decode(s_data)
    s_cpu, _ = gj.Decoder(backend="torch", device="cpu").decode(s_data)
    info_s, plan_s, _, ctx_s, rows_s = decode_parts(
        s_data, gj.ImageParameters(
            width=256, height=256, color_space=gj.ColorSpace.RGB,
            pixel_format=gj.PixelFormat.PF_444_U8_P012), "cuda")
    coeff_s = ctx_s.coefficients(rows_s).cpu().numpy()
    s_id = {}
    for device in ("cuda", "cpu"):
        dd = gj.Decoder(backend="torch", device=device)
        dd.set_output_format(info_s.color_space,
                             gj.PixelFormat.PF_444_U8_P012)
        s_id[device] = rgb_planes(torch.from_numpy(
            dd.decode(s_data)[0].reshape(256, 256, 3)))
    s_n, s_err, _, s_tie = plane_ties(s_id["cuda"], s_id["cpu"], coeff_s,
                                      plan_s, info_s)
    s_px = int((s_cuda != s_cpu).reshape(256, 256, 3).any(axis=2).sum())
    print(f"phase 6: 256x256: {s_n} values differ between the card and "
          f"the CPU plain path before the colour transform (each within "
          f"{s_tie:.3g} eps of a .5 tie), {s_px} RGB pixels", flush=True)
    if s_err > 1 or s_tie > F32_EVALS:
        fail("256x256 decode on the card differs from the CPU plain path "
             "beyond .5 ties")

    stages = np.median([dec_stage_ms(dec, data, oi) for _ in range(3)],
                       axis=0)
    ctx = next(iter(dec._contexts.values()))
    from gpujpeg_tpu_torch.ops.decode import build_rows
    info = read_image(data)
    plan, sd, segs = plan_from_info(info)
    rows_d = torch.from_numpy(build_rows(plan, sd, segs)).cuda()
    device_ms = cuda_ms(lambda: ctx.run(rows_d), 10)
    print(f"phase 6: {card}: decode first call {first_ms:.3f} ms, steady "
          f"{float(np.median(steady)):.3f} ms (median of 5, host clock, "
          f"parse, row build, upload and copy back included); D1+D2 "
          f"device {device_ms:.4f} ms (CUDA events); stats {stats}",
          flush=True)
    print(f"phase 6: {card}: decode stages (host clock, median of 3): "
          f"parse {stages[0]:.3f} ms, row build {stages[1]:.3f} ms, upload "
          f"{stages[2]:.3f} ms, D1+D2 {stages[3]:.3f} ms, D2H "
          f"{stages[4]:.3f} ms", flush=True)
    pdec = gj.Decoder(backend="torch", device="cuda", perf_stats=True)
    for _ in range(2):      # the first builds the context
        if not np.array_equal(pdec.decode(data)[0], raw):
            fail("a decode with perf_stats differs")
    st = pdec.stats.asdict()
    if min(st[k] for k in ("duration_memory_to", "duration_huffman_coder",
                           "duration_dct_quantization",
                           "duration_memory_from")) <= 0:
        fail(f"perf_stats left a decode stage empty: {st}")
    print(f"phase 6: {card}: decode stats with perf_stats (ms; kernel "
          f"stages by CUDA events): {st}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

#: one H100 SXM at its 700 W limit (NVIDIA's data sheet): device memory
#: bytes/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
#: float32 operations of one 8x8 block's (I)DCT in separable form (16
#: eight-point transforms of 8 dot products of 8 terms; an FMA counts
#: two), plus its 64 (de)quantisation multiplies and 64 level-shift adds
DCT_BLOCK_FLOPS = 2 * 16 * 8 * 8 + 64 + 64
#: a 3x3 colour transform, per block of one component (3 FMAs a value)
COLOUR_BLOCK_FLOPS = 2 * 3 * 64


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: int = 0) -> dict:
    """``bound_ms`` and ``bound_by`` of work that moves ``bytes_moved``
    (each input read once, each output written once) and does ``flops``
    float32 operations (an FMA counts two). Integer and bit operations
    have no peak in the data sheet's table and are not counted."""
    t_b = bytes_moved / PEAK_BYTES_S
    t_o = flops / PEAK_F32_S
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "operations" if t_o > t_b else "bytes"}


def used_word_bytes(bits: torch.Tensor) -> int:
    """Bytes of E2's block strings that the data fills (the rest of each
    worst-case scratch row is neither written usefully nor read)."""
    return int(((bits.long() + 31) // 32).sum()) * 4


# ---------------------------------------------------------------------------
# Phases 7-9: the general encode (E0 + E1p)
# ---------------------------------------------------------------------------

REPLACES_E0 = "gpujpeg_tpu/ops/preprocess.py:150"
REPLACES_E1P = ("gpujpeg_tpu/ops/entropy_v2.py:856 (DCT+quant half) + "
                "gpujpeg_tpu/ops/jax_pipeline.py:226")
#: phase 9's colour configs: (pixel format name, image colour space name,
#: JPEG colour space name, sampling); the six of the JAX package's
#: tests/test_quality.py, a pair of two non-RGB spaces and RGB -> RGB
SMALL_CONFIGS = [
    ("PF_444_U8_P012", "RGB", "YCBCR_BT601_256LVLS", 444),
    ("PF_444_U8_P012A", "RGB", "YCBCR_BT601_256LVLS", 444),
    ("PF_444_U8_P0P1P2", "YCBCR_BT601_256LVLS", "YCBCR_BT601_256LVLS", 444),
    ("PF_422_U8_P1020", "YCBCR_BT709", "YCBCR_BT601_256LVLS", 422),
    ("PF_420_U8_P0P1P2", "YCBCR_BT601_256LVLS", "YCBCR_BT601_256LVLS", 420),
    ("PF_422_U8_P0P1P2", "YCBCR_BT601", "YCBCR_BT601_256LVLS", 422),
    ("PF_444_U8_P012", "YUV", "YCBCR_BT601", 444),
    ("PF_444_U8_P012", "RGB", "RGB", 444),
]


def make_raw(gj, rgb: np.ndarray, image) -> np.ndarray:
    """An RGB frame in ``image``'s colour space and pixel format, by the
    port's host transform and packer (alpha 255 for 4 components)."""
    from gpujpeg_tpu_torch.ops.colorspace import transform
    from gpujpeg_tpu_torch.ops.preprocess import pack_raw
    H, W, _ = rgb.shape
    chans = transform([rgb[:, :, c].astype(np.int32) for c in range(3)],
                      gj.ColorSpace.RGB, image.color_space, np)
    if image.comp_count == 4:
        chans = chans + [np.full((H, W), 255, np.int32)]
    return pack_raw(chans, image, np)


def plan_a(gj):
    """(params, image) of (a): I420 video in, YCbCr 4:2:0 interleaved,
    Q75, the suggested pow2 restart interval."""
    i420 = gj.ImageParameters(width=W8K, height=H8K,
                              color_space=gj.ColorSpace.YCBCR_BT709,
                              pixel_format=gj.PixelFormat.PF_420_U8_P0P1P2)
    ri = gj.suggest_restart_interval(i420, True, True, pow2=True)
    if ri != 4:
        fail(f"(a): suggested restart interval {ri}, expected 4")
    return (gj.Parameters(quality=QUALITY, restart_interval=ri,
                          interleaved=True).with_chroma_subsampling(420),
            i420)


def general_configs(gj, img: np.ndarray) -> dict:
    """Phase 7's and 8's 8K configurations: name -> (raw, params, image).
    (a) of :func:`plan_a`; (c) RGB in, 4:2:0 non-interleaved, Q75, ri 32;
    (d) RGB in, 4:4:4, Q100, ri 32 (the E1 route)."""
    params_a, i420 = plan_a(gj)
    rgb = gj.ImageParameters(width=W8K, height=H8K,
                             color_space=gj.ColorSpace.RGB,
                             pixel_format=gj.PixelFormat.PF_444_U8_P012)
    return {
        "a": (make_raw(gj, img, i420), params_a, i420),
        "c": (img.reshape(-1),
              gj.Parameters(quality=QUALITY, restart_interval=32)
              .with_chroma_subsampling(420), rgb),
        "d": (img.reshape(-1), gj.Parameters(quality=100,
                                             restart_interval=32), rgb),
    }


#: the every-format sweeps of phases 7 and 10: (width, height, sampling,
#: interleaved), UYVY at the next even width
SWEEP_SIZES = [(W8K, H8K, 420, True), (1923, 1081, 422, False)]
#: phase 7's sweep: input pixel format -> (image colour space, JPEG colour
#: space): every path of E0's transform (none, inverse, forward, both)
E0_SWEEP_PAIRS = {
    "U8": ("YCBCR_BT601_256LVLS", "YCBCR_BT601_256LVLS"),
    "PF_444_U8_P012": ("RGB", "YCBCR_BT601_256LVLS"),
    "PF_444_U8_P0P1P2": ("YCBCR_BT709", "YCBCR_BT601_256LVLS"),
    "PF_422_U8_P1020": ("YCBCR_BT709", "YCBCR_BT601_256LVLS"),
    "PF_422_U8_P0P1P2": ("YCBCR_BT601", "RGB"),
    "PF_420_U8_P0P1P2": ("YUV", "YCBCR_BT601"),
    "PF_444_U8_P012Z": ("RGB", "RGB"),
    "PF_444_U8_P012A": ("RGB", "YCBCR_BT601_256LVLS"),
}


def sweep_size(pf_name: str, W: int) -> int:
    return W + W % 2 if pf_name == "PF_422_U8_P1020" and W > 1 else W


def e0_format_sweep(gj, card: str) -> None:
    """Phase 7's sweep: E0 against its plain version, bit for bit, for
    every input pixel format (1, 3 and 4 components) at 8K 4:2:0
    interleaved and at 1923x1081 4:2:2 non-interleaved, on bytes from
    ``np.random.default_rng``; with each kernel time and bound."""
    from gpujpeg_tpu_torch.ops import preprocess as pre
    from gpujpeg_tpu_torch.plan import make_plan
    n = 0
    for i, (w, h, sub, inter) in enumerate(SWEEP_SIZES):
        for j, (pf, (cs, cs_int)) in enumerate(E0_SWEEP_PAIRS.items()):
            image = gj.ImageParameters(
                width=sweep_size(pf, w), height=h,
                color_space=gj.ColorSpace[cs],
                pixel_format=gj.PixelFormat[pf])
            plan = make_plan(gj.Parameters(
                restart_interval=4, interleaved=inter,
                color_space_internal=gj.ColorSpace[cs_int])
                .with_chroma_subsampling(sub), image)
            g = pre.plane_geometry(plan, "cuda")
            raw = pre.upload_raw(np.random.default_rng(100 * i + j).integers(
                0, 256, g.raw_bytes, dtype=np.uint8), image, "cuda")
            planes = pre.preprocess_planes(raw, g)
            bad = int((planes != pre.preprocess_planes_plain(raw, g)).sum())
            bnd = bound(nbytes(raw, planes))
            ms = cuda_ms(lambda: pre.preprocess_planes(raw, g), 5)
            layout = "interleaved" if inter else "non-interleaved"
            print(f"phase 7 sweep: E0 {pf} {image.width}x{h} {cs} -> "
                  f"{cs_int} {sub} {layout}, "
                  f"{len(plan.components)} components: {bad} of "
                  f"{planes.numel()} bytes differ from the plain version; "
                  f"{card}: {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms",
                  flush=True)
            if bad:
                fail(f"E0 {pf} {image.width}x{h} disagrees with its plain "
                     "version")
            n += 1
            del raw, planes
    torch.cuda.empty_cache()
    print(f"phase 7 sweep: E0 equal to its plain version in all {n} "
          "configurations", flush=True)


def phase_general_kernels(gj, img: np.ndarray, configs: dict,
                          card: str) -> list[dict]:
    """Phase 7: E0 and E1p against their plain versions at 8K on (a) and
    (c), E2 and E3 on (a)'s coefficients, and E1p against E1 on phase
    3's 4:4:4 frame; with kernel and plain times on (a)."""
    from gpujpeg_tpu_torch.ops import dct, entropy, preprocess as pre
    rows_out = []
    for name in ("a", "c"):
        raw_h, params, image = configs[name]
        ctx = context(params, image)
        g, t = ctx.planes, ctx.tables
        raw = pre.upload_raw(raw_h, image, ctx.device)
        e0 = (raw, g)
        planes = pre.preprocess_planes(*e0)
        planes_p = pre.preprocess_planes_plain(*e0)
        e0_bad = int((planes != planes_p).sum())
        e1p = (planes, t.dct, t.bias, ctx.qdiv, g.blk, g.block_plane_idx)
        coeff = dct.fdct_quant_planes(*e1p)
        coeff_p = dct.fdct_quant_planes_plain(*e1p)
        plan = ctx.plan
        print(f"phase 7 ({name}): {image.width}x{image.height} "
              f"{gj.PixelFormat(image.pixel_format).name} -> "
              f"{len(plan.components)} planes "
              f"{[(c.data_width, c.data_height) for c in plan.components]}, "
              f"{plan.n_blocks} blocks in {plan.n_segments} segments: E0 "
              f"{e0_bad} of {planes.numel()} bytes differ from the plain "
              f"version", flush=True)
        if e0_bad:
            fail(f"({name}): E0 disagrees with its plain version")
        err = e1p_tie_check(f"phase 7 ({name}): E1p fdct_quant_planes vs "
                            "its plain version", ctx, planes, coeff,
                            coeff_p)
        if name != "a":
            e0_bnd = bound(nbytes(raw, planes))
            print(f"phase 7 ({name}): {card}: preprocess_planes "
                  f"{cuda_ms(lambda: pre.preprocess_planes(*e0), 10):.4f} "
                  f"ms, bound {e0_bnd['bound_ms']:.4f} ms "
                  f"({e0_bnd['bound_by']})", flush=True)
            del ctx, raw, planes, planes_p, coeff, coeff_p
            torch.cuda.empty_cache()
            continue
        geo = ctx.geo
        e2 = (coeff, geo.dc_pred, geo.block_cls, t.ac512, t.dc64)
        words, bits = entropy.huffman_blocks(*e2)
        words_p, bits_p = entropy.huffman_blocks_plain(*e2)
        used = (torch.arange(words.shape[1], device=words.device)[None, :]
                < ((bits + 31) // 32)[:, None])
        e2_bad = int(((words != words_p) & used).sum()) \
            + int((bits != bits_p).sum())
        del words_p, bits_p, used
        e3 = (words, bits, geo.seg_start, geo.seg_count, geo.rst,
              geo.has_rst, geo.cap_out)
        out, out_len, seg_bits, n_ff = entropy.merge_stuff(*e3)
        out_p, out_len_p, seg_bits_p, n_ff_p = entropy.merge_stuff_plain(*e3)
        valid = (torch.arange(geo.cap_out, device=out.device)[None, :]
                 < out_len_p[:, None])
        e3_bad = int(((out_len != out_len_p) | (seg_bits != seg_bits_p)
                      | (n_ff != n_ff_p)).sum()) \
            + int(((out != out_p) & valid).sum())
        print(f"phase 7 (a): E2 {e2_bad} bit lengths and string words, E3 "
              f"{e3_bad} segment lengths and bytes differ from the plain "
              f"versions ({plan.max_seg_block_count} blocks per segment, "
              f"{len(plan.components)} components interleaved, "
              f"{int(out_len.sum())} bytes)", flush=True)
        if e2_bad or e3_bad:
            fail("(a): E2 or E3 disagrees with its plain version")
        del out_p, valid
        for kname, src, repl, kern, plain, args, errv, bnd in (
                ("preprocess_planes", "preprocess.cu", REPLACES_E0,
                 pre.preprocess_planes, pre.preprocess_planes_plain, e0, 0,
                 bound(nbytes(raw, planes))),
                ("fdct_quant_planes", "fdct_quant_planes.cu", REPLACES_E1P,
                 dct.fdct_quant_planes, dct.fdct_quant_planes_plain, e1p,
                 err, bound(nbytes(planes, t.bias, ctx.qdiv, g.blk,
                                   g.block_plane_idx, coeff),
                            DCT_BLOCK_FLOPS * plan.n_blocks))):
            ms = cuda_ms(lambda: kern(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            print(f"phase 7 (a): {card}: {kname} {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']})", flush=True)
            rows_out.append({"name": kname, "route": "cuda",
                             "source": f"gpujpeg_tpu_torch/csrc/{src}",
                             "replaces": repl, "launches": 0,
                             "max_abs_err": errv, "ms": ms,
                             "plain_ms": plain_ms, **bnd,
                             "library_ms": None})
        words_used = used_word_bytes(bits)
        for kname, kern, args, bnd in (
                ("huffman_blocks", entropy.huffman_blocks, e2,
                 bound(nbytes(*e2, bits) + words_used)),
                ("merge_stuff", entropy.merge_stuff, e3,
                 bound(words_used + nbytes(*e3[1:-1], out_len, seg_bits, n_ff)
                       + int(out_len.sum())))):
            print(f"phase 7 (a): {card}: {kname} on (a) "
                  f"{cuda_ms(lambda: kern(*args), 10):.4f} ms, bound "
                  f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
        del ctx, raw, planes, planes_p, coeff, coeff_p, words, bits, out
        torch.cuda.empty_cache()

    e0_format_sweep(gj, card)

    # E1p on E0's planes of phase 3's 4:4:4 frame equals E1 bit for bit
    # (one separable form, one arithmetic)
    params, image, _ = setup(gj, H8K, W8K)
    ctx = context(params, image)
    if not ctx.rgb_route:
        fail("phase 3's plan does not take the E1 route")
    rgb = ctx.upload(img)
    by_e1 = ctx.coefficients(rgb)
    by_e1p = ctx.coefficients_planes(pre.upload_raw(img, image, ctx.device))
    n_bad = int((by_e1p != by_e1).sum())
    print(f"phase 7: E1p on E0's planes of phase 3's frame: {n_bad} of "
          f"{by_e1.numel()} coefficients differ from E1", flush=True)
    if n_bad:
        fail("phase 7: E1p on E0's planes differs from E1")
    del ctx, rgb, by_e1, by_e1p
    torch.cuda.empty_cache()
    return rows_out


def coefficient_check(gj, ctx, raw, params, image, data: bytes,
                      what: str) -> tuple[int, set]:
    """The kernels' own coefficients of ``raw`` against the float64 golden
    DCT under the per-coefficient tie rule, and the stream equal to the
    golden entropy coder's stream of those coefficients; (coefficients at
    .5 ties, the segments that hold them)."""
    from gpujpeg_tpu_torch.native import encode_segments_native
    from gpujpeg_tpu_torch.types import HuffmanType
    from gpujpeg_tpu_torch.stream.writer import assemble, join_segments
    quant_zz, huff = encode_tables(params.quality)
    plan = ctx.plan
    y64, eps = golden_quotients(raw, image, plan, quant_zz)
    coeff_k = ctx.coefficients(ctx.upload(raw)).cpu().numpy()
    n_ties, tie_segs = tie_segments(plan, coeff_k, np.rint(y64), y64,
                                    f"{what} vs golden", eps)
    del y64, eps
    segs = encode_segments_native(
        plan, coeff_k,
        [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components],
        [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components])
    if segs is None:
        fail("the native golden entropy coder did not build")
    if assemble(plan, quant_zz, huff, *join_segments(plan, segs)) != data:
        fail(f"{what}: the stream differs from the golden entropy coder's "
             "on the kernels' own coefficients")
    return n_ties, tie_segs


def golden_check(gj, ctx, raw, params, image, data: bytes, what: str):
    """The stream against the golden coder: :func:`coefficient_check`,
    byte-equal to the golden encoder's in every segment without a .5 tie,
    golden-decoded PSNR (against the raw input, in its own format) within
    PSNR_DB. Returns a summary string."""
    plan = ctx.plan
    gold = gj.Encoder(backend="golden").encode(raw, params, image)
    n_ties, tie_segs = coefficient_check(gj, ctx, raw, params, image, data,
                                         what)
    bad = differing_segments(plan, data, gold, tie_segs)
    dec = gj.Decoder(backend="golden")
    dec.set_output_format(image.color_space, image.pixel_format)
    ref = np.asarray(raw, np.uint8).reshape(-1)
    p_t = psnr(dec.decode(data)[0].reshape(-1), ref)
    p_g = psnr(dec.decode(gold)[0].reshape(-1), ref)
    msg = (f"{len(data)} bytes, equal to the golden entropy coder's on "
           f"the kernels' coefficients; PSNR {p_t:.4f} dB vs golden "
           f"{p_g:.4f} dB; against the golden encoder "
           f"{n_ties} coefficients at .5 ties in {len(tie_segs)} segments; "
           f"{len(bad)} of the other {plan.n_segments - len(tie_segs)} "
           f"segments differ from golden")
    if bad:
        fail(f"{what}: segments {bad[:10]} differ from the golden stream")
    if abs(p_t - p_g) > PSNR_DB:
        fail(f"{what}: PSNR differs from the golden stream's by more than "
             "0.1 dB")
    return msg


def phase_general_encode(gj, configs: dict, card: str) -> dict:
    """Phase 8: ``Encoder.encode`` end to end at 8K on (a), (c) and (d):
    each kernel of the route launched once per encode, the stream against
    golden, first-call and steady times, (a)'s stage breakdown. Returns
    (a)'s launch counts."""
    from gpujpeg_tpu_torch.ops import dct, entropy, preprocess as pre
    kernels = (pre.preprocess_planes, dct.fdct_quant_planes, dct.fdct_quant,
               entropy.huffman_blocks, entropy.merge_stuff)
    launches_a = None
    for name in ("a", "c", "d"):
        raw, params, image = configs[name]
        enc = gj.Encoder(backend="torch", device="cuda")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        data = enc.encode(raw, params, image)
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {k.__name__: k.launches for k in kernels}
        ctx = next(iter(enc._contexts.values()))
        route = ((dct.fdct_quant,) if ctx.rgb_route else
                 (pre.preprocess_planes, dct.fdct_quant_planes)) + (
            entropy.huffman_blocks, entropy.merge_stuff)
        want = {k.__name__: int(k in route) for k in kernels}
        if launches != want:
            fail(f"({name}): launches {launches}, expected {want}")
        if name == "a":
            launches_a = launches
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            again = enc.encode(raw, params, image)
            steady.append((time.perf_counter() - t0) * 1e3)
        if again != data:
            fail(f"({name}): two encodes of one frame differ")
        x = ctx.upload(raw)
        device_ms = cuda_ms(lambda: ctx.run(x), 10)
        del x
        summary = golden_check(gj, ctx, raw, params, image, data,
                               f"({name})")
        plan = ctx.plan
        print(f"phase 8 ({name}): encode {image.width}x{image.height} "
              f"{gj.PixelFormat(image.pixel_format).name} "
              f"{gj.ColorSpace(image.color_space).name} -> "
              f"{len(plan.components)} components, sampling "
              f"{[str(c.sampling) for c in plan.components]}, interleaved "
              f"{params.interleaved}, Q{params.quality} ri="
              f"{params.restart_interval}, {plan.n_segments} segments: "
              f"launches {launches}; {summary}", flush=True)
        print(f"phase 8 ({name}): {card}: encode first call {first_ms:.3f} "
              f"ms, steady {float(np.median(steady)):.3f} ms (median of 5, "
              f"host clock); kernels device {device_ms:.4f} ms (CUDA "
              f"events)", flush=True)
        if name == "a":
            quant_zz, huff = encode_tables(params.quality)
            st = np.median([stage_ms(ctx, raw, quant_zz, huff)
                            for _ in range(3)], axis=0)
            print(f"phase 8 (a): {card}: encode stages (host clock, median "
                  f"of 3): upload {st[0]:.3f} ms, E0-E3 {st[1]:.3f} ms, "
                  f"length sync + compaction + D2H {st[2]:.3f} ms, stream "
                  f"assembly {st[3]:.3f} ms", flush=True)
        del enc, ctx
        torch.cuda.empty_cache()
    return launches_a


def phase_small(gj) -> None:
    """Phase 9: every colour config at 17x13 and 200x136, interleaved or
    not, encoded on the card and through the CPU plain path: equal
    streams, or equal in every segment without a .5 tie."""
    n = 0
    for pf_name, cs_name, csi_name, sub in SMALL_CONFIGS:
        pf = gj.PixelFormat[pf_name]
        for (w, h), interleaved in ((s, i) for s in ((17, 13), (200, 136))
                                    for i in (False, True)):
            if pf == gj.PixelFormat.PF_422_U8_P1020:
                w += w % 2
            image = gj.ImageParameters(width=w, height=h,
                                       color_space=gj.ColorSpace[cs_name],
                                       pixel_format=pf)
            params = gj.Parameters(
                quality=85, restart_interval=2, interleaved=interleaved,
                color_space_internal=gj.ColorSpace[csi_name]
            ).with_chroma_subsampling(sub)
            raw = make_raw(gj, make_image(h, w), image)
            a = gj.Encoder(backend="torch", device="cuda").encode(
                raw, params, image)
            b = gj.Encoder(backend="torch", device="cpu").encode(
                raw, params, image)
            n += 1
            if a != b:
                print(f"phase 9: {pf_name} {cs_name}->{csi_name} {w}x{h} "
                      f"interleaved {interleaved}: "
                      f"{card_vs_cpu(raw, params, image, a, b)}",
                      flush=True)
    print(f"phase 9: {n} small encodes ({len(SMALL_CONFIGS)} colour configs "
          f"x 17x13, 200x136 x interleaved or not) equal the CPU plain "
          f"path's streams outside .5 ties", flush=True)


# ---------------------------------------------------------------------------
# Phases 10-12: the general decode (D1 -> D2p -> D3)
# ---------------------------------------------------------------------------

REPLACES_K4 = "gpujpeg_tpu/ops/pallas_decode_v3.py:545"
REPLACES_K5 = "gpujpeg_tpu/ops/pallas_decode.py:329"
REPLACES_D2P = ("gpujpeg_tpu/ops/jax_pipeline.py:1156 (scan reorder) + "
                "gpujpeg_tpu/ops/dct.py:42 + gpujpeg_tpu/ops/blocks.py:15")
REPLACES_D3 = "gpujpeg_tpu/ops/preprocess.py:173"
#: the JAX package's v3/v2 decoder threshold (``pallas_decode.V3_WCAP_MAX``):
#: rows wider than this many words take K5 there
V3_WCAP_MAX = 384


def decode_streams(gj, img: np.ndarray, configs: dict) -> dict:
    """Phase 10-11's 8K streams, encoded on the card: name -> bytes. (a)
    and (c) of phase 8; (d) RGB 4:4:4 Q100 ri=32; (e) RGB 4:4:4 Q100
    ri=64, whose rows exceed V3_WCAP_MAX words (the K5 regime)."""
    rgb = gj.ImageParameters(width=W8K, height=H8K,
                             color_space=gj.ColorSpace.RGB,
                             pixel_format=gj.PixelFormat.PF_444_U8_P012)
    todo = {k: configs[k] for k in ("a", "c", "d")}
    todo["e"] = (img.reshape(-1), gj.Parameters(quality=100,
                                                restart_interval=64), rgb)
    enc = gj.Encoder(backend="torch", device="cuda")
    out = {k: enc.encode(raw, params, image)
           for k, (raw, params, image) in todo.items()}
    del enc
    torch.cuda.empty_cache()
    return out


def out_images(gj) -> dict:
    """The general decode's outputs at 8K: name -> output image."""
    def im(cs, pf):
        return gj.ImageParameters(width=W8K, height=H8K,
                                  color_space=gj.ColorSpace[cs],
                                  pixel_format=gj.PixelFormat[pf])
    return {"a": im("YCBCR_BT709", "PF_420_U8_P0P1P2"),
            "c": im("RGB", "PF_444_U8_P012"),
            "e-rgb": im("RGB", "PF_444_U8_P012"),
            "e": im("YCBCR_BT601_256LVLS", "PF_444_U8_P0P1P2")}


def split_planes(flat: np.ndarray, plan) -> list:
    out, off = [], 0
    for c in plan.components:
        n = c.data_width * c.data_height
        out.append(flat[off:off + n].reshape(c.data_height, c.data_width))
        off += n
    return out


def plane_ties(a, b, coeff, plan, info) -> tuple[int, int, float, float]:
    """(values that differ, max |d|, largest |frac(y64) - .5| over them,
    largest |frac(y64) - .5| / eps over them) between two flat plane
    arrays of one plan (y64: the float64 IDCT value + 128 of the
    scan-order coefficients ``coeff``; eps = F32_DOT_REL * (|x| @ |W| +
    128), the float32 error bound of the dense and the separable IDCT)."""
    from gpujpeg_tpu_torch.tables import idct_dequant_matrix
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    idx = np.flatnonzero(d)
    if idx.size == 0:
        return 0, 0, 0.0, 0.0
    coeff = np.asarray(coeff)
    inv = np.empty(plan.n_blocks, np.int64)
    inv[plan.block_plane_idx] = np.arange(plan.n_blocks)
    dist = np.full(idx.size, np.inf)
    eps = np.ones(idx.size)
    off = 0
    for c in plan.components:
        n = c.data_width * c.data_height
        sel = (idx >= off) & (idx < off + n)
        local = idx[sel] - off
        r, col = local // c.data_width, local % c.data_width
        pb = c.plane_block_offset + (r // 8) * c.block_count_x + col // 8
        p = (r % 8) * 8 + col % 8
        W64 = idct_dequant_matrix(np.asarray(
            info.quant_tables[info.components[c.index].quant_table_index]))
        x = coeff[inv[pb]].astype(np.float64)
        y = np.einsum("nk,nk->n", x, W64[:, p].T) + 128.0
        dist[sel] = np.abs(y - np.floor(y) - 0.5)
        eps[sel] = F32_DOT_REL * (np.einsum("nk,nk->n", np.abs(x),
                                            np.abs(W64[:, p].T)) + 128.0)
        off += n
    return (int(idx.size), int(d.max()), float(dist.max()),
            float((dist / eps).max()))


def phase_general_decode_kernels(gj, streams: dict, main_data: bytes,
                                 card: str) -> tuple[list, dict]:
    """Phase 10: D1, D2p and D3 against their plain versions and the
    golden decoder at 8K on (a), (c) and (e); D2p + D3 against D2 on the
    main path's stream and on (e); kernel and plain times. Returns the
    kernels' rows and, per stream, (plan, info, D1's coefficients, the
    golden decoder's planes) for phase 11."""
    from gpujpeg_tpu_torch.models.decoder import golden_planes
    from gpujpeg_tpu_torch.native import decode_segments_native
    from gpujpeg_tpu_torch.ops import dct, decode, preprocess as pre
    outs = out_images(gj)
    rows_out, gold = [], {}
    for name in ("a", "c", "d", "e"):
        data = streams[name]
        out_image = outs.get(name, outs["c"])
        info, plan, gold_args, ctx, rows = decode_parts(data, out_image,
                                                         "cuda")
        regime = "K5" if rows.shape[1] > V3_WCAP_MAX else "K4"
        print(f"phase 10 ({name}): {len(data)} bytes, {plan.n_blocks} blocks "
              f"in {plan.n_segments} segments, rows {tuple(rows.shape)}: "
              f"wcap {rows.shape[1]} words ({regime} regime in the JAX "
              f"package)", flush=True)
        if name == "e" and rows.shape[1] <= V3_WCAP_MAX:
            fail(f"(e): wcap {rows.shape[1]} is not above {V3_WCAP_MAX}")
        if name == "d":
            continue
        t, b, g = ctx.tables, ctx.blocks, ctx.out
        d1 = (rows, ctx.seg_start, ctx.seg_count, ctx.block_comp, t.wide,
              t.maxcode, t.delta, t.huffval, t.dc_slot, t.ac_slot)
        coeff = decode.huffman_decode(*d1)
        coeff_p, d1_plain_ms = cuda_ms_once(
            lambda: decode.huffman_decode_plain(*d1))
        coeff_h = coeff.cpu().numpy()
        gold_c = decode_segments_native(*gold_args)
        bad_p = int((coeff != coeff_p).sum())
        bad_g = int((coeff_h != gold_c).sum())
        del coeff_p
        d2p = (coeff, t.quant, t.q_of, b.blk, b.block_plane_idx, b.total)
        planes = dct.idct_planes(*d2p)
        planes_p = dct.idct_planes_plain(*d2p)
        planes_h = planes.cpu().numpy()
        n_p, err_p, _, tie_p = plane_ties(planes_h, planes_p.cpu().numpy(),
                                          coeff_h, plan, info)
        gold_pl = np.concatenate([p.reshape(-1) for p in
                                  golden_planes(info, plan, gold_c)])
        n_g, err_g, _, tie_g = plane_ties(planes_h, gold_pl, coeff_h, plan,
                                          info)
        gold[name] = (plan, info, coeff_h, gold_pl)
        del planes_p, gold_c
        d3 = (planes, g)
        raw = pre.postprocess_planes(*d3)
        raw_p = pre.postprocess_planes_plain(*d3)
        host = np.asarray(pre.postprocess(split_planes(planes_h, plan),
                                          out_image, plan, np))
        raw_h = raw.cpu().numpy()
        bad_d3 = int((raw != raw_p).sum()) + int((raw_h != host).sum())
        print(f"phase 10 ({name}): D1 {bad_p} coefficients differ from the "
              f"plain version, {bad_g} from the native golden decoder; D2p "
              f"{n_p} of {b.total} values differ from the plain version "
              f"(max |d| {err_p}, each within {tie_p:.3g} eps of a .5 tie, "
              f"allowed {F32_EVALS}), {n_g} from the golden float64 IDCT "
              f"(max |d| {err_g}, within {tie_g:.3g} eps, allowed 1); D3 to "
              f"{gj.PixelFormat(out_image.pixel_format).name} "
              f"{gj.ColorSpace(out_image.color_space).name}: {bad_d3} bytes "
              f"differ from the plain version and the host postprocess",
              flush=True)
        if bad_p or bad_g:
            fail(f"({name}): D1 disagrees with its plain version or golden")
        if err_p > 1 or tie_p > F32_EVALS:
            fail(f"({name}): D2p disagrees with its plain version beyond .5 "
                 "ties")
        if err_g > 1 or tie_g > 1:
            fail(f"({name}): D2p disagrees with the golden IDCT beyond .5 "
                 "ties")
        if bad_d3:
            fail(f"({name}): D3 disagrees with its plain version or the host "
                 "postprocess")

        if name == "a":
            kern = [("idct_planes", "idct_planes.cu", REPLACES_D2P,
                     dct.idct_planes, dct.idct_planes_plain, d2p, err_p,
                     bound(nbytes(*d2p[:-1], planes),
                           DCT_BLOCK_FLOPS * plan.n_blocks)),
                    ("postprocess_planes", "postprocess.cu", REPLACES_D3,
                     pre.postprocess_planes, pre.postprocess_planes_plain,
                     d3, 0, bound(nbytes(planes, raw)))]
        else:
            kern = []
            d3_bnd = bound(nbytes(planes, raw))
            print(f"phase 10 ({name}): {card}: postprocess_planes to "
                  f"{gj.PixelFormat(out_image.pixel_format).name} "
                  f"{cuda_ms(lambda: pre.postprocess_planes(*d3), 10):.4f} "
                  f"ms, bound {d3_bnd['bound_ms']:.4f} ms "
                  f"({d3_bnd['bound_by']})", flush=True)
        if name in ("a", "e"):
            kern.insert(0, (f"huffman_decode[{regime} regime ({name})]",
                            "huffman_decode.cu",
                            REPLACES_K4 if name == "a" else REPLACES_K5,
                            decode.huffman_decode, None, d1, 0,
                            bound(nbytes(*d1, coeff))))
        for kname, src, repl, fn, plain, args, errv, bnd in kern:
            ms = cuda_ms(lambda: fn(*args), 10)
            plain_ms = d1_plain_ms if plain is None else \
                cuda_ms(lambda: plain(*args), 2)
            print(f"phase 10 ({name}): {card}: {kname} {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']})", flush=True)
            rows_out.append({"name": kname, "route": "cuda",
                             "source": f"gpujpeg_tpu_torch/csrc/{src}",
                             "replaces": repl, "launches": 0,
                             "max_abs_err": errv, "ms": ms,
                             "plain_ms": plain_ms, **bnd,
                             "library_ms": None})
        del ctx, rows, coeff, planes, raw, raw_p
        torch.cuda.empty_cache()

    # D2p + D3 against D2 on 4:4:4 streams, before the colour transform
    # (output in the stream's own colour space) and after it: equal bit for
    # bit (one separable form, one arithmetic); both timed to RGB
    from gpujpeg_tpu_torch.ops.rgbpack import transform_consts_tensor
    xf_id = transform_consts_tensor((None, None), "cuda")
    for name, data in (("main path", main_data), ("e", streams["e"])):
        info, plan, _, ctx, rows = decode_parts(data, outs["c"], "cuda")
        if not ctx.rgb_route:
            fail(f"{name}: the stream does not take the D2 route")
        coeff = ctx.coefficients(rows)
        t = ctx.tables
        H, W = ctx.shape
        b = pre.block_geometry(plan, "cuda")
        og = pre.out_geometry(plan, outs["c"], "cuda")
        og_id = pre.out_geometry(plan, gj.ImageParameters(
            width=W, height=H, color_space=info.color_space,
            pixel_format=gj.PixelFormat.PF_444_U8_P012), "cuda")

        def tail(geo):
            return pre.postprocess_planes(dct.idct_planes(
                coeff, t.quant, t.q_of, b.blk, b.block_plane_idx, b.total),
                geo)
        by_d2 = dct.idct_rgb(coeff, t.quant, t.q_of, xf_id, ctx.interleaved,
                             H, W).view(-1)
        n_bad = int((by_d2 != tail(og_id)).sum())
        n_rgb = int((ctx.pixels(coeff) != tail(og)).sum())
        d2_ms = cuda_ms(lambda: ctx.pixels(coeff), 10)
        tail_ms = cuda_ms(lambda: tail(og), 10)
        planes = dct.idct_planes(coeff, t.quant, t.q_of, b.blk,
                                 b.block_plane_idx, b.total)
        d3_ms = cuda_ms(lambda: pre.postprocess_planes(planes, og), 10)
        d3_bnd = bound(planes.numel() + og.raw_bytes)
        print(f"phase 10: {name}: D2p + D3 against D2: {n_bad} of "
              f"{by_d2.numel()} values differ before the colour transform, "
              f"{n_rgb} RGB bytes after it; {card}: to RGB D2 {d2_ms:.4f} "
              f"ms, D2p + D3 {tail_ms:.4f} ms (D3 {d3_ms:.4f} ms, bound "
              f"{d3_bnd['bound_ms']:.4f} ms)", flush=True)
        del planes
        if n_bad or n_rgb:
            fail(f"{name}: D2p + D3 differs from D2")
        del ctx, rows, coeff, by_d2
        torch.cuda.empty_cache()
    d3_format_sweep(gj, card)
    return rows_out, gold


#: phase 10's sweep: output pixel format -> output colour space (the
#: streams are YCbCr BT.601 256 levels): every path of D3's transform
D3_SWEEP_SPACES = {
    "U8": "YCBCR_BT601_256LVLS",
    "PF_444_U8_P012": "RGB",
    "PF_444_U8_P0P1P2": "YCBCR_BT709",
    "PF_422_U8_P1020": "YCBCR_BT709",
    "PF_422_U8_P0P1P2": "YCBCR_BT601_256LVLS",
    "PF_420_U8_P0P1P2": "YCBCR_BT709",
    "PF_444_U8_P012Z": "RGB",
    "PF_444_U8_P012A": "RGB",
}


def d3_format_sweep(gj, card: str) -> None:
    """Phase 10's sweep: D3 against its plain version, bit for bit, for
    every output pixel format from streams of 1, 3 and 4 components (gray
    4:4:4, and the sampling of ``SWEEP_SIZES`` for 3 and 4) at 8K and at
    1923x1081 (1924x1081 for UYVY), on planes from
    ``np.random.default_rng``; with each kernel time and bound. UYVY and
    planar output of one component raise, as ``postprocess`` does, and are
    left out."""
    from gpujpeg_tpu_torch.ops import preprocess as pre
    from gpujpeg_tpu_torch.plan import make_plan
    n = 0
    for i, (w0, h, sub, inter) in enumerate(SWEEP_SIZES):
        for k, in_pf in enumerate(("U8", "PF_444_U8_P012",
                                   "PF_444_U8_P012A")):
            params = gj.Parameters(restart_interval=4, interleaved=inter)
            if in_pf != "U8":
                params = params.with_chroma_subsampling(sub)
            streams = {}   # width -> (plan, planes)
            for pf, cs in D3_SWEEP_SPACES.items():
                w = sweep_size(pf, w0)
                if w not in streams:
                    plan = make_plan(params, gj.ImageParameters(
                        width=w, height=h,
                        pixel_format=gj.PixelFormat[in_pf]))
                    total = sum(c.data_width * c.data_height
                                for c in plan.components)
                    streams[w] = (plan, torch.from_numpy(
                        np.random.default_rng(200 + 10 * i + k + w % 2)
                        .integers(0, 256, total, dtype=np.uint8)).to("cuda"))
                plan, planes = streams[w]
                C = len(plan.components)
                if C < 3 and pf in ("PF_422_U8_P1020", "PF_444_U8_P0P1P2",
                                    "PF_422_U8_P0P1P2", "PF_420_U8_P0P1P2"):
                    continue
                g = pre.out_geometry(plan, gj.ImageParameters(
                    width=w, height=h, color_space=gj.ColorSpace[cs],
                    pixel_format=gj.PixelFormat[pf]), "cuda")
                raw = pre.postprocess_planes(planes, g)
                bad = int((raw != pre.postprocess_planes_plain(planes, g))
                          .sum())
                bnd = bound(planes.numel() + raw.numel())
                ms = cuda_ms(lambda: pre.postprocess_planes(planes, g), 5)
                layout = "interleaved" if inter and C > 1 else \
                    "non-interleaved"
                print(f"phase 10 sweep: D3 {C} components, "
                      f"{sub if C > 1 else 444} {layout}, "
                      f"{w}x{h} -> {pf} {cs}: {bad} of {raw.numel()} bytes "
                      f"differ from the plain version; {card}: {ms:.4f} ms, "
                      f"bound {bnd['bound_ms']:.4f} ms", flush=True)
                if bad:
                    fail(f"D3 {C} components -> {pf} {w}x{h} disagrees "
                         "with its plain version")
                n += 1
                del raw
            del streams, planes
    torch.cuda.empty_cache()
    print(f"phase 10 sweep: D3 equal to its plain version in all {n} "
          "configurations", flush=True)


def phase_general_decode(gj, img: np.ndarray, streams: dict, gold: dict,
                         card: str) -> dict:
    """Phase 11: ``Decoder.decode`` end to end at 8K: (a) to I420 BT.709,
    (c) to RGB, (e) to RGB (D2) and to planar 4:4:4 YCbCr (D2p + D3).
    Each kernel of the route launched once per decode; the output equal
    to the host postprocess of the card's own planes, those planes within
    the tie rule of the golden decoder's (phase 10), PSNR within 0.01 dB
    of the golden decoder's; first-call, steady and stage times. Returns
    the launch counts of (a) and (e) to planar (K4 and K5 regimes)."""
    from gpujpeg_tpu_torch.ops import dct, decode, preprocess as pre
    from gpujpeg_tpu_torch.ops.decode import build_rows
    from gpujpeg_tpu_torch.ops.rgbpack import transform_consts_tensor
    kernels = (decode.huffman_decode, dct.idct_rgb, dct.idct_planes,
               pre.postprocess_planes)
    outs = out_images(gj)
    xf_id = transform_consts_tensor((None, None), "cuda")
    launches = {}
    for name in ("a", "c", "e-rgb", "e"):
        data = streams[name[0]]
        out_image = outs[name]
        dec = gj.Decoder(backend="torch", device="cuda")
        dec.set_output_format(out_image.color_space, out_image.pixel_format)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out, oi = dec.decode(data)
        first_ms = (time.perf_counter() - t0) * 1e3
        got = {k.__name__: k.launches for k in kernels}
        ctx = next(iter(dec._contexts.values()))
        route = (dct.idct_rgb,) if ctx.rgb_route else (dct.idct_planes,
                                                       pre.postprocess_planes)
        want = {k.__name__: int(k in (decode.huffman_decode,) + route)
                for k in kernels}
        if got != want:
            fail(f"({name}): launches {got}, expected {want}")
        launches[name] = got
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            again, _ = dec.decode(data)
            steady.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(again, out):
            fail(f"({name}): two decodes of one stream differ")
        stages = np.median([dec_stage_ms(dec, data, out_image)
                            for _ in range(3)], axis=0)

        # the output is the exact postprocess of the card's own planes,
        # and those are within the tie rule of the golden decoder's
        plan, info, coeff_h, gold_pl = gold[name[0]]
        b = pre.block_geometry(plan, "cuda")
        t = ctx.tables
        _, sd, segs = plan_from_info(info)
        coeff = ctx.coefficients(torch.from_numpy(
            build_rows(plan, sd, segs)).cuda())
        if ctx.rgb_route:       # D2's own values before the transform
            planes_h = rgb_planes(dct.idct_rgb(
                coeff, t.quant, t.q_of, xf_id, ctx.interleaved, *ctx.shape))
        else:
            planes_h = dct.idct_planes(coeff, t.quant, t.q_of, b.blk,
                                       b.block_plane_idx,
                                       b.total).cpu().numpy()
        host = np.asarray(pre.postprocess(split_planes(planes_h, plan),
                                          out_image, plan, np))
        n_out = int((host != out).sum())
        n_g, err_g, tie_g, tie_ge = plane_ties(planes_h, gold_pl, coeff_h,
                                               plan, info)
        ref = make_raw(gj, img, out_image)
        gd = gj.Decoder(backend="golden")
        gd.set_output_format(out_image.color_space, out_image.pixel_format)
        gold_out = gd.decode(data)[0]
        p_t, p_g = psnr(out, ref), psnr(gold_out, ref)
        n_diff = int((gold_out != out).sum())
        print(f"phase 11 ({name}): decode {W8K}x{H8K} -> "
              f"{gj.PixelFormat(out_image.pixel_format).name} "
              f"{gj.ColorSpace(out_image.color_space).name} ({out.size} "
              f"bytes): launches {got}; {n_out} bytes differ from the host "
              f"postprocess of the card's planes; planes against golden "
              f"{n_g} values differ (max |d| {err_g}, farthest from a .5 tie "
              f"{tie_g:.3g}, {tie_ge:.3g} eps); {n_diff} output bytes differ "
              f"from the golden "
              f"decoder's; PSNR {p_t:.4f} dB vs golden {p_g:.4f} dB",
              flush=True)
        print(f"phase 11 ({name}): {card}: decode first call {first_ms:.3f} "
              f"ms, steady {float(np.median(steady)):.3f} ms (median of 5, "
              f"host clock); stages (median of 3): parse {stages[0]:.3f} ms, "
              f"row build {stages[1]:.3f} ms, upload {stages[2]:.3f} ms, "
              f"kernels {stages[3]:.3f} ms, D2H {stages[4]:.3f} ms",
              flush=True)
        if n_out:
            fail(f"({name}): the output is not the postprocess of the card's "
                 "planes")
        if err_g > 1 or tie_ge > 1:
            fail(f"({name}): the planes differ from golden beyond .5 ties")
        if abs(p_t - p_g) > DEC_PSNR_DB:
            fail(f"({name}): PSNR differs from the golden decode's by more "
                 "than 0.01 dB")
        del dec, ctx, coeff
        torch.cuda.empty_cache()
    return launches


def f4_check(gj, what: str, data: bytes, params, image, card: str) -> None:
    """F4 on the card: ``decode_to_device`` of ``data`` to ``image``'s
    pixel format, then ``Encoder.encode`` of that CUDA tensor, as it is
    and as its int32 words, equal to the encode of the same bytes from
    the host; each encode timed (host clock, median of 3 after a first
    call)."""
    dec = gj.Decoder(backend="torch", device="cuda")
    dec.set_output_format(image.color_space, image.pixel_format)
    frame, _ = dec.decode_to_device(data)
    if not (isinstance(frame, torch.Tensor) and frame.is_cuda
            and frame.dtype == torch.uint8):
        fail(f"(F4 {what}): decode_to_device gave {type(frame)}, not a "
             "uint8 CUDA tensor")
    forms = {"host bytes": frame.cpu().numpy(), "the CUDA tensor": frame,
             "its int32 view": frame.view(torch.int32)}
    enc = gj.Encoder(backend="torch", device="cuda")
    streams, ms = {}, {}
    for name, raw in forms.items():
        streams[name] = enc.encode(raw, params, image)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            enc.encode(raw, params, image)
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(runs))
    bad = [name for name in forms if streams[name] != streams["host bytes"]]
    if bad:
        fail(f"(F4 {what}): the encode of {bad} differs from the encode of "
             "the same bytes from the host")
    print(f"phase 11 (F4 {what}): decode_to_device -> Encoder.encode of the "
          f"CUDA frame ({frame.numel()} bytes): the stream ("
          f"{len(streams['host bytes'])} bytes) equals the encode of the "
          f"same bytes from the host, from the tensor and from its int32 "
          f"view; {card}: encode " + ", ".join(
              f"from {k} {v:.3f} ms" for k, v in ms.items())
          + " (median of 3, host clock)", flush=True)
    del dec, enc, frame, forms
    torch.cuda.empty_cache()


#: phase 12's stream plans: (name, input pixel format, sampling,
#: interleaved)
SMALL_DECODES = [("444", "PF_444_U8_P012", 444, False),
                 ("420i", "PF_444_U8_P012", 420, True),
                 ("422", "PF_444_U8_P012", 422, False),
                 ("gray", "U8", 444, False),
                 ("4comp", "PF_444_U8_P012A", 420, True)]


def phase_small_decode(gj) -> None:
    """Phase 12: every output format x {4:4:4, 4:2:0 interleaved, 4:2:2,
    grayscale, 4 components (RGBA input, 4:2:0 interleaved)} x {17x13,
    200x136} decoded on the card and through the CPU plain path with no
    golden route: equal, or equal to the plain D3 of the card's own
    planes, which differ from the CPU's only at .5 IDCT ties. UYVY takes
    the next even width; gray streams skip UYVY and the planar formats
    (``postprocess`` packs neither from one component)."""
    import gpujpeg_tpu_torch.models.decoder as dmod
    from gpujpeg_tpu_torch.ops import dct, preprocess as pre
    from gpujpeg_tpu_torch.ops.rgbpack import (
        planes_to_rgb, transform_consts_tensor)
    from gpujpeg_tpu_torch.stream.reader import read_image
    xf_id = transform_consts_tensor((None, None), "cuda")
    planar = ("PF_422_U8_P1020", "PF_444_U8_P0P1P2", "PF_422_U8_P0P1P2",
              "PF_420_U8_P0P1P2")
    old = dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = dmod.CPU_BLOCK_THRESHOLD = 0
    n = n_eq = 0
    try:
        for (sname, in_pf, sub, inter), (w, h), opf in (
                (s, z, f) for s in SMALL_DECODES
                for z in ((17, 13), (200, 136))
                for f in gj.PixelFormat.__members__ if f != "NONE"):
            if sname == "gray" and opf in planar:
                continue
            if opf == "PF_422_U8_P1020":
                w += w % 2
            image = gj.ImageParameters(width=w, height=h,
                                       pixel_format=gj.PixelFormat[in_pf])
            params = gj.Parameters(quality=85, restart_interval=2,
                                   interleaved=inter
                                   ).with_chroma_subsampling(sub)
            src = make_image(h, w)
            if in_pf == "U8":
                src = src[..., :1]
            elif in_pf == "PF_444_U8_P012A":
                src = np.concatenate([src, make_image(h, w, 8)[..., :1]], 2)
            raw = src.reshape(-1)
            data = gj.Encoder(backend="golden").encode(raw, params, image)
            out_image = gj.ImageParameters(
                width=w, height=h,
                color_space=gj.ColorSpace.YCBCR_BT709 if opf in planar
                else gj.ColorSpace.RGB, pixel_format=gj.PixelFormat[opf])
            n_comp = read_image(data).comp_count
            if n_comp != {"gray": 1, "4comp": 4}.get(sname, 3):
                fail(f"phase 12: the {sname} stream has {n_comp} components")
            res = {}
            before = (dct.idct_planes.launches, pre.postprocess_planes.launches)
            for device in ("cuda", "cpu"):
                dd = gj.Decoder(backend="torch", device=device)
                dd.set_output_format(out_image.color_space,
                                     out_image.pixel_format)
                res[device] = dd.decode(data)[0]
            if sname == "4comp" and (
                    dct.idct_planes.launches == before[0]
                    or pre.postprocess_planes.launches == before[1]):
                fail(f"phase 12: 4comp {w}x{h} -> {opf} did not launch D2p "
                     "and D3")
            n += 1
            if np.array_equal(res["cuda"], res["cpu"]):
                n_eq += 1
                continue
            info, plan, _, ctx, rows = decode_parts(data, out_image,
                                                     "cuda")
            coeff = ctx.coefficients(rows)
            t = ctx.tables
            if ctx.rgb_route:
                # D2 (separable) against the CPU's plain D2 (dense) before
                # the colour transform, by phase 5's rule; the card's
                # output is the transform of its own values
                args = (coeff, t.quant, t.q_of, xf_id, ctx.interleaved,
                        *ctx.shape)
                vals = dct.idct_rgb(*args)
                n_p, err_p, _, tie_p = plane_ties(
                    rgb_planes(vals), rgb_planes(dct.idct_rgb_plain(*(
                        a.cpu() if torch.is_tensor(a) else a for a in args))),
                    coeff.cpu().numpy(), plan, info)
                xv = ctx.xf.tolist()
                own = planes_to_rgb(vals.permute(2, 0, 1).int(), (
                    None, None) if xv[12] else (xv[:9], xv[9:12]))
                own = own.reshape(-1).cpu().numpy()
            else:
                # D2p (separable) against the CPU's plain D2p (dense), by
                # the same rule; the output is D3 of the card's planes
                b = pre.block_geometry(plan, "cuda")
                args = (coeff, t.quant, t.q_of, b.blk, b.block_plane_idx,
                        b.total)
                pl_card = dct.idct_planes(*args).cpu()
                pl_cpu = dct.idct_planes_plain(*(
                    a.cpu() if torch.is_tensor(a) else a for a in args))
                n_p, err_p, _, tie_p = plane_ties(
                    pl_card.numpy(), pl_cpu.numpy(), coeff.cpu().numpy(),
                    plan, info)
                own = pre.postprocess_planes_plain(
                    pl_card, pre.out_geometry(plan, out_image, "cpu")).numpy()
            print(f"phase 12: {sname} {w}x{h} -> {opf}: the card's output "
                  f"differs from the CPU path's; {n_p} plane values differ "
                  f"(max |d| {err_p}, each within {tie_p:.3g} eps of a .5 "
                  f"tie, allowed {F32_EVALS})", flush=True)
            if not np.array_equal(own, res["cuda"]) or err_p > 1 \
                    or tie_p > F32_EVALS:
                fail(f"phase 12: {sname} {w}x{h} -> {opf}: the card differs "
                     "from the CPU path beyond .5 IDCT ties")
    finally:
        dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD = old
    print(f"phase 12: {n} small decodes ({len(SMALL_DECODES)} stream plans "
          f"x 17x13, 200x136 x output formats) on the card: {n_eq} equal to "
          f"the CPU plain path's, the others outside .5 ties", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the stage-1 probes (E12, its stop modes, copy_bytes, E0 as S3)
# ---------------------------------------------------------------------------

REPLACES_K12 = "gpujpeg_tpu/ops/entropy_v2.py:637"
REPLACES_S1 = "scripts/perf_stage1.py:77"
REPLACES_S2 = "scripts/ablate_stage1.py:193"
REPLACES_S3 = "scripts/perf_rgbpack.py:47"
#: phase 13 (iv): copy_bytes's lengths, and the byte offsets of source
#: and destination from a 16-byte boundary
COPY_EDGE_LENGTHS = (0, 1, 15, 16, 17, 4095, (1 << 20) + 3)
COPY_EDGE_OFFSETS = (0, 1, 8, 15)
COPY_GUARD = 64


def copy_edges_check(dev) -> int:
    """copy_bytes's C entry (the wrapper's kernel; the wrapper allocates
    an aligned destination) for every length of COPY_EDGE_LENGTHS from
    every source offset to every destination offset of
    COPY_EDGE_OFFSETS, each into a buffer with COPY_GUARD bytes on either
    side: the copy must be byte-exact and the guards untouched. Returns
    the number of copies. Each length's launch must be the tool's
    ``copy_grid``."""
    from gpujpeg_tpu_torch import _build
    from gpujpeg_tpu_torch.tools import perf_stage1
    n_max = max(COPY_EDGE_LENGTHS)
    src = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, n_max + 16, dtype=np.uint8)).to(dev)
    n = 0
    for length in COPY_EDGE_LENGTHS:
        if perf_stage1.copy_launch(length) != perf_stage1.copy_grid(length):
            fail(f"(iv): copy_bytes launches {perf_stage1.copy_launch(length)}"
                 f" for {length} bytes, copy_grid says "
                 f"{perf_stage1.copy_grid(length)}")
        for so in COPY_EDGE_OFFSETS:
            for do in COPY_EDGE_OFFSETS:
                dst = torch.full((length + 16 + 2 * COPY_GUARD,), 0xA5,
                                 dtype=torch.uint8, device=dev)
                want = dst.clone()
                d0 = COPY_GUARD + do
                want[d0:d0 + length] = src[so:so + length]
                _build.launch("gj_copy_bytes", dev, src.data_ptr() + so,
                              dst.data_ptr() + d0, length)
                if not torch.equal(dst, want):
                    fail(f"(iv): copy_bytes of {length} bytes from offset "
                         f"{so} to offset {do} is not byte-exact or writes "
                         f"outside its destination")
                n += 1
    return n


def e12_mismatch(kern, plain, cap_words: int, stop: str) -> torch.Tensor:
    """(NB,) bool: blocks whose E12 outputs differ from the plain
    version's (the walking modes compare the words a string fills)."""
    (words, bits), (words_p, bits_p) = kern, plain
    if stop in ("lookups", "full"):
        n = (torch.clamp(bits, max=32 * cap_words) + 31) // 32
        used = (torch.arange(cap_words, device=bits.device)[None, :]
                < n[:, None])
        return ((words != words_p) & used).any(1) | (bits != bits_p)
    return (words != words_p).any(1) | (bits != bits_p)


def e12_exact_check(what: str, kern, plain, cap_words: int,
                    stop: str) -> None:
    """Fails unless E12's output equals ``plain`` in every block."""
    n = int(e12_mismatch(kern, plain, cap_words, stop).sum())
    if n:
        fail(f"{what}: {n} blocks differ")


def e1p_quotients(blocks, qsel, qdiv, tables) -> torch.Tensor:
    """E1p's quotients (NB, 64) of E12's (NB, 64) row-major blocks, each by
    its own divisor row ``qdiv[qsel]``: per distinct divisor row (at most
    4) one copy of the blocks as an 8-pixel-wide plane, each block read
    first from the copy of its row (E1p codes every plane block, the
    others after). E12 computes its quotients with E1p's
    arithmetic (dct8.cuh's passes, then one subtraction, one division,
    rintf), and its ``dct`` mode shows only 8 values of a pair's left
    block: these are the quotients E12's walk codes."""
    from gpujpeg_tpu_torch.ops import dct
    uq, inv = torch.unique(qdiv, dim=0, return_inverse=True)
    C, NB = uq.shape[0], blocks.shape[0]
    if C > 4:
        fail(f"E12's divisors hold {C} distinct rows, E1p takes 4")
    dev = blocks.device
    blk = torch.tensor([[c * NB * 64, 8, c * NB, 1] for c in range(C)],
                       dtype=torch.int32, device=dev)
    own = inv[qsel.long()] * NB + torch.arange(NB, device=dev)
    rest = torch.ones(C * NB, dtype=torch.bool, device=dev)
    rest[own] = False      # E1p takes every plane block: the others last
    bpi = torch.cat([own, torch.nonzero(rest)[:, 0]]).int()
    return dct.fdct_quant_planes(blocks.reshape(-1).repeat(C), tables.dct,
                                 tables.bias, uq.contiguous(), blk,
                                 bpi)[:NB]


def pair_value_check(what: str, kern, plain, blocks, qsel, qdiv,
                     cap_words: int, stop: str) -> int:
    """E1's per-value rule for E12's value modes (``dctonly``, ``dct``,
    ``dctmul``), whose pair rows show values 0..7 of each pair's left
    block: a value may differ from the plain version's only by 1, and
    only where its float64 value lies within ``F32_EVALS`` eps of the
    rounding edge (an integer for ``dctonly``'s truncation, .5 for the
    others; eps as ``golden_quotients``). Fails otherwise; returns the
    number of values that differ."""
    from gpujpeg_tpu_torch.tables import dct_zigzag_operator
    (w_k, b_k), (w_p, b_p) = kern, plain
    dw = w_k.long() - w_p.long()
    rows, ws = torch.nonzero(dw, as_tuple=True)
    rb = torch.nonzero(b_k != b_p)[:, 0]
    e = torch.cat([rows - (rows & 1), rb - (rb & 1)])
    j = torch.cat([(rows & 1) * cap_words + ws, rb & 1])
    d = torch.cat([dw[rows, ws], (b_k - b_p)[rb].long()]).abs()
    n = int(d.numel())
    if n == 0:
        return 0
    if int(j.max()) >= 8 or int(d.max()) > 1:
        fail(f"{what}: values differ by more than 1 or past the pair row")
    D64, bias64 = dct_zigzag_operator()
    D = torch.as_tensor(D64[:, :8], device=blocks.device)
    bias = torch.as_tensor(bias64[:8], device=blocks.device)
    x = blocks[e].double()
    y = (x @ D - bias).gather(1, j[:, None])[:, 0]
    eps = F32_DOT_REL * (x @ D.abs() + bias.abs()).gather(
        1, j[:, None])[:, 0]
    q = qdiv.double()[qsel[e].long(), j]
    if stop == "dctonly":
        far, tol = (y - torch.round(y)).abs(), eps
    else:
        v, tol = (y * q, eps * q) if stop == "dctmul" else (y / q, eps / q)
        far = (v - torch.floor(v) - 0.5).abs()
    worst = float((far / tol).max())
    if worst > F32_EVALS:
        fail(f"{what}: a value differs {worst:.3g} eps from its rounding "
             f"edge (allowed {F32_EVALS})")
    return n


def phase_stage1(gj, img: np.ndarray, card: str) -> tuple[list, dict]:
    """Phase 13: the port's stage-1 probe tools at 8K (their launch
    counts), then (i) E12 against its plain version on perf_stage1's
    inputs, (ii) E12 + E3 against E1p -> E2 -> E3 on E0's planes of
    phase 3's frame, (iii) each stop mode against its plain version on
    ablate_stage1's inputs, (iv) copy_bytes byte-exact, beside clone(),
    (v) E0 on perf_rgbpack's frame against its plain version ((iv) and
    (v) are checked by the tools' own runs, which raise). Returns the
    kernels' rows and launches."""
    from gpujpeg_tpu_torch.ops import dct, entropy, preprocess as pre
    from gpujpeg_tpu_torch.tools import (
        ablate_stage1, mean_ms, perf_rgbpack, perf_stage1)
    dev = torch.device("cuda")
    e12 = entropy.dct_huffman_blocks
    copy = perf_stage1.copy_bytes
    t0 = time.perf_counter()

    # the tools' paths, each driven with its counts at 0
    e12.launches = dict.fromkeys(entropy.STOP_MODES, 0)
    copy.launches = 0
    inp = perf_stage1.make_inputs(perf_stage1.STAGES, H8K, W8K, dev)
    tool = {r["stage"]: r for r in perf_stage1.run(inp, perf_stage1.STAGES,
                                                   dev, 10)}
    launches = {"dct_huffman_blocks": e12.launches["full"],
                "copy_bytes": copy.launches}
    e12.launches = dict.fromkeys(entropy.STOP_MODES, 0)
    ab_args, W = ablate_stage1.make_inputs(H8K, W8K, dev)
    ab = {r["stage"]: r for r in ablate_stage1.run(
        ab_args, W, entropy.STOP_MODES, dev, 10)}
    launches.update({f"dct_huffman_blocks[{m}]": e12.launches[m]
                     for m in entropy.STOP_MODES})
    pre.preprocess_planes.launches = 0
    frame = perf_rgbpack.make_frame(H8K, W8K)
    rg = {r["stage"]: r for r in perf_rgbpack.run(frame, ("pack",), dev, 10)}
    launches["preprocess_planes[S3]"] = pre.preprocess_planes.launches
    for name, r in (("perf_stage1", tool["copy"]), ("perf_stage1",
                                                    tool["stage1"]),
                    ("perf_stage1", tool["merge"]), ("perf_rgbpack",
                                                     rg["pack"])):
        print(f"phase 13: {card}: {name} {r}", flush=True)
    print(f"phase 13: {card}: ablate_stage1 "
          f"{ {m: r['ms'] for m, r in ab.items()} } ms", flush=True)
    print(f"phase 13: launches on the tools' paths {launches}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the tools' paths did not launch: {launches}")

    rows = []

    def row(name, src, repl, ms, plain_ms, err, bnd, library_ms=None):
        rows.append({"name": name, "route": "cuda",
                     "source": f"gpujpeg_tpu_torch/csrc/{src}",
                     "replaces": repl, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, **bnd,
                     "library_ms": library_ms})

    # (i) E12 with cap_words = W against its plain version: the values by
    # E1's per-value rule (E12's separable DCT against the dense plain
    # one), the strings exactly on E12's own quotients (E1p's arithmetic)
    args = perf_stage1.e12_args(inp, W)
    blocks, qsel, qdiv = args[0], args[4], args[5]
    q_own = e1p_quotients(blocks, qsel, qdiv, inp.tables)
    n_val = pair_value_check("(i) E12[dct]", e12(*args[:-1], "dct"),
                             entropy.dct_huffman_blocks_plain(*args[:-1],
                                                              "dct"),
                             blocks, qsel, qdiv, W, "dct")
    e12_exact_check("(i) E12[dct] against its own quotients",
                    e12(*args[:-1], "dct"),
                    entropy.e12_from_quotients(q_own, *args[1:4], *args[8:10],
                                               W, "dct"), W, "dct")
    out = e12(*args)
    e12_exact_check("(i) E12 against the plain walk of its own quotients",
                    out, entropy.e12_from_quotients(q_own, *args[1:4],
                                                    *args[8:10], W), W,
                    "full")
    plain, plain_ms = cuda_ms_once(lambda: entropy.dct_huffman_blocks_plain(
        *args))
    n_bad = int(e12_mismatch(out, plain, W, "full").sum())
    err = int((out[1] - plain[1]).abs().max())
    NB = blocks.shape[0]
    held, _ = mean_ms(lambda: e12(*args), dev, 20, hold=True)
    print(f"phase 13 (i): E12 dct_huffman_blocks on perf_stage1's {NB} "
          f"blocks, W {W}: equal to the plain walk of its own quotients "
          f"(E1p's) in every block, {int((out[1] > 32 * W).sum())} strings "
          f"cut at {32 * W} bits; [dct] {n_val} values differ from the "
          f"dense plain version's, each at a tie; {n_bad} blocks differ "
          f"from the plain version's strings; {card}: "
          f"{tool['stage1']['ms']:.4f} ms (held {held:.4f}), plain "
          f"{plain_ms:.4f} ms", flush=True)
    e12_bytes = nbytes(*args[:6], *args[7:10], *out)
    row("dct_huffman_blocks", "dct_huffman_blocks.cu", REPLACES_K12,
        tool["stage1"]["ms"], plain_ms, err,
        bound(e12_bytes, NB * DCT_BLOCK_FLOPS))
    del out, plain, q_own

    # (ii) E12 (cap BLOCK_CAP_WORDS) + E3 against E1p -> E2 -> E3, equal in
    # every segment (E12's quotients are E1p's); E12 is timed on blocks
    # gathered in scan order beforehand and with that gather (plain
    # torch), which E1p does inside its kernel
    params, image, plan = setup(gj, H8K, W8K)
    ctx = context(params, image)
    t, g, geo = ctx.tables, ctx.planes, ctx.geo
    planes = pre.preprocess_planes(pre.upload_raw(img, image, dev), g)
    e1p = (planes, t.dct, t.bias, ctx.qdiv, g.blk, g.block_plane_idx)
    coeff = dct.fdct_quant_planes(*e1p)
    blocks, comp = dct.scan_order_blocks(planes, g.blk, g.block_plane_idx)
    comp = comp.to(torch.int32)
    dc = coeff[:, 0].long()
    pred = geo.dc_pred.long()
    diff = (dc - torch.where(pred < 0, 0, dc[pred.clamp(min=0)])).int()
    ones = torch.ones_like(diff)
    fused = (blocks, diff, geo.block_cls, ones, comp, ctx.qdiv, t.dct,
             t.bias, t.ac512, t.dc64, entropy.BLOCK_CAP_WORDS)
    seg = (geo.seg_start, geo.seg_count, geo.rst, geo.has_rst, geo.cap_out)
    got = entropy.merge_stuff(*e12(*fused), *seg)
    want = ctx.entropy(coeff)
    valid = (torch.arange(geo.cap_out, device=dev)[None, :]
             < want[1][:, None])
    seg_bad = (got[1] != want[1]) | ((got[0] != want[0]) & valid).any(1)
    n_seg_bad = int(seg_bad.sum())
    if n_seg_bad:
        fail(f"(ii): E12 + E3 differs from E1p -> E2 -> E3 in {n_seg_bad} "
             "segments")
    fused_ms = cuda_ms(lambda: e12(*fused), 10)
    gather_ms = cuda_ms(lambda: e12(dct.scan_order_blocks(
        planes, g.blk, g.block_plane_idx)[0], *fused[1:]), 10)
    two_ms = cuda_ms(lambda: entropy.huffman_blocks(
        dct.fdct_quant_planes(*e1p), geo.dc_pred, geo.block_cls, t.ac512,
        t.dc64), 10)
    fused_held, _ = mean_ms(lambda: e12(*fused), dev, 20, hold=True)
    two_held, _ = mean_ms(lambda: entropy.huffman_blocks(
        dct.fdct_quant_planes(*e1p), geo.dc_pred, geo.block_cls, t.ac512,
        t.dc64), dev, 20, hold=True)
    verdict = "wins" if fused_ms < two_ms and fused_held < two_held \
        else "does not win"
    print(f"phase 13 (ii): E12 + E3 on E0's planes of phase 3's frame: "
          f"equal to E1p -> E2 -> E3 in all {plan.n_segments} segments "
          f"({int(want[1].sum())} bytes); {card}: E12 (cap "
          f"{entropy.BLOCK_CAP_WORDS} words) {fused_ms:.4f} ms (held "
          f"{fused_held:.4f}) on blocks gathered beforehand, "
          f"{gather_ms:.4f} ms with the plain scan-order gather, E1p + E2 "
          f"{two_ms:.4f} ms (held {two_held:.4f}): fusion saves "
          f"{two_ms - fused_ms:.4f} ms without the gather, "
          f"{two_ms - gather_ms:.4f} ms with it; fusion {verdict}",
          flush=True)
    del ctx, planes, coeff, blocks, got, want, valid
    torch.cuda.empty_cache()

    # (iii) each stop mode against its plain version on ablate's inputs:
    # io and passthru exactly, the value modes by E1's per-value rule,
    # synth, lookups and full exactly on E12's own quotients
    NBa = ab_args[0].shape[0]
    q_own = e1p_quotients(ab_args[0], ab_args[4], ab_args[5], inp.tables)
    for m in entropy.STOP_MODES:
        out = e12(*ab_args, W, m)
        plain = entropy.dct_huffman_blocks_plain(*ab_args, W, m)
        if m in ("io", "passthru"):
            e12_exact_check(f"(iii) E12[{m}]", out, plain, W, m)
            how = "equal to the plain version's in every block"
        elif m in ("dctonly", "dct", "dctmul"):
            n_val = pair_value_check(f"(iii) E12[{m}]", out, plain,
                                     ab_args[0], ab_args[4], ab_args[5], W,
                                     m)
            how = (f"{n_val} values differ from the plain version's, each "
                   "at a tie")
        if m in ("dct", "synth", "lookups", "full"):
            e12_exact_check(f"(iii) E12[{m}] against its own quotients",
                            out, entropy.e12_from_quotients(
                                q_own, *ab_args[1:4], *ab_args[8:10], W, m),
                            W, m)
            if m != "dct":
                n_bad = int(e12_mismatch(out, plain, W, m).sum())
                how = (f"equal to the plain output of its own quotients in "
                       f"every block ({n_bad} blocks differ from the plain "
                       f"version's)")
        err = int((out[1] - plain[1]).abs().max())
        p_ms = cuda_ms(lambda: entropy.dct_huffman_blocks_plain(
            *ab_args, W, m), 1)
        held, _ = mean_ms(lambda: e12(*ab_args, W, m), dev, 20, hold=True)
        print(f"phase 13 (iii): E12[{m}] on ablate_stage1's {NBa} blocks: "
              f"{how}; {card}: {ab[m]['ms']:.4f} ms (held {held:.4f}), "
              f"plain {p_ms:.4f} ms", flush=True)
        row(f"dct_huffman_blocks[{m}]", "dct_huffman_blocks.cu", REPLACES_S2,
            ab[m]["ms"], p_ms, err,
            bound(nbytes(*ab_args[:5], *out), 0) if m in ("io", "passthru")
            else
            bound(nbytes(*ab_args[:6], *ab_args[7:], *out),
                  NBa * DCT_BLOCK_FLOPS))
        del out, plain
    del q_own

    # (iv) copy_bytes (the tool held it to its input), beside clone()
    x = torch.as_tensor(inp.copy_src, device=dev)
    c = tool["copy"]
    p_ms = cuda_ms(lambda: perf_stage1.copy_bytes_plain(x), 10)
    bnd = bound(2 * x.numel())
    print(f"phase 13 (iv): copy_bytes {x.numel()} bytes byte-exact; {card}: "
          f"{c['ms']:.4f} ms ({2 * x.numel() / c['ms'] / 1e9:.4f} TB/s), clone() "
          f"{c['clone_ms']:.4f} ms ({2 * x.numel() / c['clone_ms'] / 1e9:.4f} "
          f"TB/s); runs held: {c['ms_held']:.4f} ms, clone() "
          f"{c['clone_ms_held']:.4f} ms; bound {bnd['bound_ms']:.4f} ms",
          flush=True)
    row("copy_bytes", "copy_bytes.cu", REPLACES_S1, c["ms"], p_ms, 0, bnd,
        c["clone_ms"])
    n_edge = copy_edges_check(dev)
    print(f"phase 13 (iv): copy_bytes byte-exact in {n_edge} copies of "
          f"{list(COPY_EDGE_LENGTHS)} bytes from and to offsets "
          f"{list(COPY_EDGE_OFFSETS)}, {COPY_GUARD} guard bytes each side "
          "untouched", flush=True)

    # (v) E0 on perf_rgbpack's frame (the tool held it to its plain version)
    plan = perf_stage1.stage1_plan(H8K, W8K)[0]
    g = pre.plane_geometry(plan, dev)
    raw = pre.upload_raw(frame.reshape(-1), plan.image, dev)
    words = perf_rgbpack.plane_words(pre.preprocess_planes(raw, g), H8K, W8K)
    p_ms = cuda_ms(lambda: pre.preprocess_planes_plain(raw, g), 2)
    bnd = bound(nbytes(raw, words))
    print(f"phase 13 (v): E0 on perf_rgbpack's frame: {rg['pack']['words']} "
          f"words equal to the plain version's; {card}: "
          f"{rg['pack']['ms']:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms, copy_bytes of the same {raw.numel()} "
          f"bytes {tool['copy']['ms']:.4f} ms", flush=True)
    row("preprocess_planes[S3]", "preprocess.cu", REPLACES_S3,
        rg["pack"]["ms"], p_ms, 0, bnd)
    del inp, ab_args, x, raw, words
    torch.cuda.empty_cache()

    # (vi) E0 and D3 on the 8K cells, whole and with the transform cut
    from gpujpeg_tpu_torch.tools import perf_pixels
    for r in perf_pixels.run(perf_pixels.STAGES, dev, H8K, W8K, 10):
        print(f"phase 13 (vi): {card}: {r['stage']}: {r['kernel']} "
              f"{r['ms']:.4f} ms (held), bound {r['bound_ms']:.4f} ms, "
              f"{100 * r['share_of_bound']:.1f}% of it", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, launches


# ---------------------------------------------------------------------------
# Phase 14: the batch and command-line entry points
# ---------------------------------------------------------------------------

#: phase 14's batches: frames of the main path at 8K, of (a) at 4K
BATCH_8K, BATCH_4K, H4K, W4K = 8, 16, 2160, 3840


def host_ms(fn) -> float:
    """Host-clock ms of ``fn()``, ended by a sync of the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def peak_bytes(fn) -> int:
    """Device bytes allocated at the peak of ``fn()`` above those
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def count_launches(kernels, fn, n: int, what: str) -> dict:
    """``fn()`` with the kernels' counts set to 0; fail unless each
    launched ``n`` times; the counts."""
    for k in kernels:
        k.launches = 0
    fn()
    launches = {k.__name__: k.launches for k in kernels}
    if any(v != n for v in launches.values()):
        fail(f"phase 14 {what}: launches {launches}, expected {n} each")
    return launches


def batch_vs_loop(batch, loop, n: int) -> tuple[float, float]:
    """Per-frame ms of ``batch()`` and of ``loop()`` over ``n`` frames,
    median of 3 each, in turns (loop, batch)."""
    b, lp = [], []
    for _ in range(3):
        lp.append(host_ms(loop) / n)
        b.append(host_ms(batch) / n)
    return float(np.median(b)), float(np.median(lp))


def i420_frames(gj, img: np.ndarray, image, n: int) -> list:
    """``n`` I420 frames of ``img`` in ``image``'s colour space, each plane
    rolled along its rows by 16 pixels more than the last (8 in the
    chroma planes)."""
    H, W = image.height, image.width
    raw = make_raw(gj, img, image)
    y = raw[:H * W].reshape(H, W)
    u, v = raw[H * W:].reshape(2, H // 2, W // 2)
    return [np.concatenate([np.roll(y, 16 * k, 1).ravel(),
                            np.roll(u, 8 * k, 1).ravel(),
                            np.roll(v, 8 * k, 1).ravel()])
            for k in range(n)]


def run_cli(*args: str, timeout: int = 300) -> str:
    """``python -m gpujpeg_tpu_torch *args`` from the checkout's root;
    fail unless it exits 0; its standard output."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "gpujpeg_tpu_torch", *args],
                       cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        fail(f"phase 14 (v): gpujpeg_tpu_torch {' '.join(args)} exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
    return r.stdout


def phase_batch(gj, img: np.ndarray, data: bytes, card: str) -> list:
    """Phase 14: warm-up and memory, ``encode_batch``, ``decode_batch``,
    the bench hook, the CLI and the examples; returns the batch rows."""
    import tempfile

    from gpujpeg_tpu_torch.ops import dct, decode, entropy, preprocess
    from gpujpeg_tpu_torch.stream.reader import JpegParseError

    t_phase = time.perf_counter()
    params, image, _ = setup(gj, H8K, W8K)
    raw = img.reshape(-1)

    # (i) warm-up, first encode, peak memory against max_memory
    enc = gj.Encoder(backend="torch", device="cuda")
    warm_ms = host_ms(lambda: enc.warmup(params, image))
    first_ms = host_ms(lambda: enc.encode(raw, params, image))
    del enc
    peaks = {}
    for name, q in (("main path Q75", QUALITY), ("(d) Q100", 100)):
        p = gj.Parameters(quality=q, restart_interval=32)
        peaks[name] = peak_bytes(lambda: gj.Encoder(
            backend="torch", device="cuda").encode(raw, p, image))
    bound = gj.Encoder.max_memory(W8K * H8K)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 14 (i): {card}: Encoder.warmup of a fresh encoder "
          f"{warm_ms:.3f} ms (kernels already loaded by phase 2), then its "
          f"first 8K encode {first_ms:.3f} ms (host clock); peak device "
          f"memory of one 8K encode: " + ", ".join(
              f"{k} {v} B ({v / (W8K * H8K):.2f} B a pixel)"
              for k, v in peaks.items())
          + f"; Encoder.max_memory({W8K}x{H8K}) = {bound} B; "
          f"max_pixels({total}) = {gj.Encoder.max_pixels(total)}",
          flush=True)
    if max(peaks.values()) > bound:
        fail(f"phase 14 (i): a peak {peaks} passes max_memory {bound}")

    # (ii) encode_batch against the loop of encode
    enc = gj.Encoder(backend="torch", device="cuda")
    frames8 = [np.roll(img, 16 * k, axis=1).reshape(-1)
               for k in range(BATCH_8K)]
    params_a, _ = plan_a(gj)
    image4 = gj.ImageParameters(width=W4K, height=H4K,
                                color_space=gj.ColorSpace.YCBCR_BT709,
                                pixel_format=gj.PixelFormat.PF_420_U8_P0P1P2)
    frames4 = i420_frames(gj, make_image(H4K, W4K), image4, BATCH_4K)
    e1 = (dct.fdct_quant, entropy.huffman_blocks, entropy.merge_stuff)
    e0 = (preprocess.preprocess_planes, dct.fdct_quant_planes,
          entropy.huffman_blocks, entropy.merge_stuff)
    d2 = (decode.huffman_decode, dct.idct_rgb)
    d3 = (decode.huffman_decode, dct.idct_planes,
          preprocess.postprocess_planes)
    rows, streams = [], {}
    cells = (("main path 8K", frames8, params, image, e1, d2,
              (gj.ColorSpace.RGB, gj.PixelFormat.PF_444_U8_P012)),
             ("(a) 4K", frames4, params_a, image4, e0, d3,
              (gj.ColorSpace.YCBCR_BT709, gj.PixelFormat.PF_420_U8_P0P1P2)))
    for name, frames, p, im, ekern, dkern, out_format in cells:
        n = len(frames)
        want = [enc.encode(f, p, im) for f in frames]
        got = []
        e_launch = count_launches(
            ekern, lambda: got.extend(enc.encode_batch(frames, p, im)), n,
            f"(ii) {name}")
        bad = [i for i in range(n) if got[i] != want[i]]
        if bad:
            fail(f"phase 14 (ii) {name}: the batch's streams {bad} differ "
                 "from encode of the same frames")
        e_batch, e_loop = batch_vs_loop(
            lambda: enc.encode_batch(frames, p, im),
            lambda: [enc.encode(f, p, im) for f in frames], n)
        print(f"phase 14 (ii): {card}: encode_batch of {n} frames of "
              f"{name} ({sum(map(len, got))} bytes): every stream equals "
              f"encode of its frame; launches {e_launch}; {e_batch:.3f} ms "
              f"a frame against the loop of encode's {e_loop:.3f} ms "
              f"(host clock, median of 3)", flush=True)
        streams[name] = got

        # (iii) decode_batch of those streams against the loop of decode
        dec = gj.Decoder(backend="torch", device="cuda")
        dec.set_output_format(*out_format)
        want_raw = [dec.decode(d)[0] for d in got]
        outs = []
        d_launch = count_launches(
            dkern, lambda: outs.extend(dec.decode_batch(got)), n,
            f"(iii) {name}")
        bad = [i for i in range(n) if not (
            isinstance(outs[i][0], np.ndarray)
            and np.array_equal(outs[i][0], want_raw[i]))]
        if bad:
            fail(f"phase 14 (iii) {name}: the batch's frames {bad} differ "
                 "from decode of the same streams")
        del outs, want_raw
        d_batch, d_loop = batch_vs_loop(
            lambda: dec.decode_batch(got),
            lambda: [dec.decode(d) for d in got], n)
        print(f"phase 14 (iii): {card}: decode_batch of those {n} streams "
              f"to {out_format[1].name}: every frame equals decode of its "
              f"stream; launches {d_launch}; {d_batch:.3f} ms a frame "
              f"against the loop of decode's {d_loop:.3f} ms (host clock, "
              f"median of 3)", flush=True)
        rows.append({"cell": name, "frames": n, "card": card,
                     "encode_batch_ms_per_frame": e_batch,
                     "encode_loop_ms_per_frame": e_loop,
                     "decode_batch_ms_per_frame": d_batch,
                     "decode_loop_ms_per_frame": d_loop,
                     "encode_launches": e_launch,
                     "decode_launches": d_launch})
        del dec
    del frames4
    torch.cuda.empty_cache()

    # (iii) a mixed batch, a corrupt stream, decode_to_device
    small = gj.Encoder(backend="golden").encode(
        make_image(136, 200).reshape(-1),
        gj.Parameters(quality=QUALITY, restart_interval=0),
        gj.ImageParameters(width=200, height=136,
                           color_space=gj.ColorSpace.RGB,
                           pixel_format=gj.PixelFormat.PF_444_U8_P012))
    tiny = gj.Encoder(backend="golden").encode(
        make_image(32, 40).reshape(-1),
        gj.Parameters(quality=QUALITY, restart_interval=2),
        gj.ImageParameters(width=40, height=32,
                           color_space=gj.ColorSpace.RGB,
                           pixel_format=gj.PixelFormat.PF_444_U8_P012))
    main = streams["main path 8K"]
    mixed = [main[0], streams["(a) 4K"][0], small, tiny, main[1]]
    dec = gj.Decoder(backend="torch", device="cuda")
    if dec._golden_route(dec._job(gj.read_image(small)).plan):
        fail("phase 14 (iii): the 200x136 stream without restart markers "
             "does not take the lane route")
    if not dec._golden_route(dec._job(gj.read_image(tiny)).plan):
        fail("phase 14 (iii): the 40x32 stream (under 32 segments) does "
             "not take the golden route")
    outs = dec.decode_batch(mixed)
    for i, d in enumerate(mixed):
        w, oi = dec.decode(d)
        if not (np.array_equal(outs[i][0], w)
                and outs[i][1].width == oi.width):
            fail(f"phase 14 (iii): frame {i} of the mixed batch differs "
                 "from its decode")
    try:
        dec.decode_batch([main[0], b"\xff\xd8garbage", main[1]])
        fail("phase 14 (iii): a corrupt stream in a batch did not raise")
    except JpegParseError:
        pass
    after, _ = dec.decode(main[1])
    dec.output_to_device = True
    dev = dec.decode_batch(main[:3])
    dec.output_to_device = False
    if not all(isinstance(r, torch.Tensor) and r.is_cuda for r, _ in dev):
        fail("phase 14 (iii): decode_to_device through the batch did not "
             "give CUDA tensors")
    if not torch.equal(dev[1][0].cpu(), torch.from_numpy(after)):
        fail("phase 14 (iii): a CUDA frame of the batch differs from the "
             "host decode")
    del dev, outs
    print("phase 14 (iii): a mixed batch (8K, 4K to RGB, 200x136 on the "
          "lane route, 40x32 on the golden route, 8K) equals the "
          "per-frame decodes; a corrupt "
          "stream in the middle raised JpegParseError and a decode after "
          "it succeeded; output_to_device through the batch gave CUDA "
          "tensors equal to the host decode", flush=True)

    # (iv) the bench hook
    dec.capture_device_call = True
    ref_raw, _ = dec.decode(data)
    fn, args = dec.last_device_call
    if not (all(a.device.type == "cuda" for a in args)
            and torch.equal(fn(*args).cpu(), torch.from_numpy(ref_raw))):
        fail("phase 14 (iv): the captured device call's replay differs from "
             "the decode")
    replay_ms = cuda_ms(lambda: fn(*args), 10)
    print(f"phase 14 (iv): {card}: capture_device_call's replay of the 8K "
          f"main-path decode equals its output; replay {replay_ms:.4f} ms "
          f"(CUDA events, mean of 10)", flush=True)
    del dec, fn, args
    torch.cuda.empty_cache()

    # (v) the command line
    from gpujpeg_tpu_torch import cli
    from gpujpeg_tpu_torch.utils import image_io
    listing = run_cli("-L", timeout=120)
    if torch.cuda.get_device_name(0) not in listing:
        fail(f"phase 14 (v): -L does not name the card: {listing!r}")
    with tempfile.TemporaryDirectory() as tmp:
        ppm, jpg, back = (os.path.join(tmp, n)
                          for n in ("in.ppm", "out.jpg", "back.ppm"))
        image_io.save_image(ppm, raw, image)
        run_cli("-e", ppm, jpg)
        with open(jpg, "rb") as f:
            if f.read() != data:
                fail("phase 14 (v): -e of the 8K PPM differs from "
                     "Encoder.encode of its pixels")
        run_cli("-d", jpg, back)
        back_raw, _ = image_io.load_image(back)
        want, _ = gj.Decoder(backend="torch", device="cuda").decode(data)
        if not np.array_equal(back_raw, want):
            fail("phase 14 (v): -d differs from Decoder.decode")
        hd = gj.ImageParameters(width=1920, height=1080,
                                color_space=gj.ColorSpace.YCBCR_BT601_256LVLS,
                                pixel_format=gj.PixelFormat.PF_420_U8_P0P1P2)
        video = i420_frames(gj, make_image(1080, 1920), hd, 8)
        y4m = os.path.join(tmp, "in.y4m")
        with open(y4m, "wb") as f:
            f.write(image_io.y4m_write(image_io.Y4mInfo(
                width=1920, height=1080, subsampling=420), video))
        pattern = os.path.join(tmp, "f_%02d.jpg")
        run_cli(y4m, pattern)
        args = cli.build_parser().parse_args([y4m, pattern])
        p_cli, im_cli = cli._adjust_params(
            args, gj.Parameters(quality=75, restart_interval=8,
                                perf_stats=True),
            gj.ImageParameters(width=0, height=0,
                               color_space=gj.ColorSpace.NONE,
                               pixel_format=gj.PixelFormat.NONE), y4m, True)
        enc = gj.Encoder(backend="torch", device="cuda")
        for i, frame in enumerate(video):
            with open(pattern % i, "rb") as f:
                if f.read() != enc.encode(frame, p_cli, im_cli):
                    fail(f"phase 14 (v): frame {i} of the Y4M batch differs "
                         "from its encode")
    print(f"phase 14 (v): -L names {torch.cuda.get_device_name(0)}; -e of "
          f"the 8K PPM equals Encoder.encode, -d back equals "
          f"Decoder.decode; a Y4M of 8 HD frames to a %d pattern gives the "
          f"per-frame encodes (restart interval {p_cli.restart_interval})",
          flush=True)

    # (vi) the examples at their defaults
    root = os.path.dirname(os.path.abspath(__file__))
    for name in ("device_array_roundtrip", "video_pipeline"):
        r = subprocess.run([sys.executable, "-m",
                            f"gpujpeg_tpu_torch.examples.{name}"],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            fail(f"phase 14 (vi): examples/{name}.py exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        print(f"phase 14 (vi): {card}: examples/{name}.py: "
              + " | ".join(r.stdout.strip().splitlines()), flush=True)
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 15: the parallel layer
# ---------------------------------------------------------------------------

#: (v)'s ranks: each takes this many bands of cuda:0 for its own frames
#: and for its share of the single image
RANK_BANDS = 2


def sharded_count(kernels, fn, n: int, what: str) -> dict:
    """``fn()`` with the kernels' counts set to 0; fail unless each
    launched ``n`` times (once a band); the counts."""
    for k in kernels:
        k.launches = 0
    fn()
    launches = {k.__name__: k.launches for k in kernels}
    if any(v != n for v in launches.values()):
        fail(f"phase 15 {what}: launches {launches}, expected {n} each "
             "(one a band)")
    return launches


def median_ms(fn) -> float:
    """Host-clock median of 3 runs of ``fn()``, each ended by a sync."""
    return float(np.median([host_ms(fn) for _ in range(3)]))


def sharded_pair(gj, par, what: str, mesh, raw, params, image, want: bytes,
                 ekern, dkern, card: str, timed: bool) -> tuple[dict, bytes]:
    """``ShardedEncoder`` of one frame and ``ShardedDecoder`` of its stream
    over ``mesh``: the stream equal to ``want`` (``Encoder.encode`` on the
    card at the same interval), the frame equal to ``Decoder.decode``'s,
    each kernel once a band; with ``timed``, both beside the
    single-device calls (host clock, median of 3). Returns the launch
    counts (route name -> counts) and the stream."""
    n = mesh.shape["seg"]
    enc = par.ShardedEncoder(mesh)
    got = []
    e_launch = sharded_count(
        ekern, lambda: got.append(enc.encode(raw, params, image)), n,
        f"{what} encode")
    if got[0] != want:
        fail(f"phase 15 {what}: the sharded stream differs from "
             "Encoder.encode's at the same interval")
    dec = par.ShardedDecoder(mesh)
    single = gj.Decoder(backend="torch", device=mesh.devices[0, 0])
    ref_raw, ref_oi = single.decode(want)
    outs = []
    d_launch = sharded_count(
        dkern, lambda: outs.append(dec.decode(want)), n, f"{what} decode")
    raw_s, oi = outs[0]
    if not (np.array_equal(raw_s, ref_raw) and oi == ref_oi):
        fail(f"phase 15 {what}: the sharded decode differs from "
             "Decoder.decode's")
    line = (f"phase 15 {what}: {card}: {n} bands on "
            f"{', '.join(str(d) for d in mesh.devices[0])}: the stream "
            f"({len(want)} bytes) equals Encoder.encode's, the frame "
            f"({gj.PixelFormat(oi.pixel_format).name}) Decoder.decode's; "
            f"launches {e_launch}, {d_launch}")
    if timed:
        enc1 = gj.Encoder(backend="torch", device=mesh.devices[0, 0])
        enc1.encode(raw, params, image)
        t = [median_ms(lambda: enc.encode(raw, params, image)),
             median_ms(lambda: enc1.encode(raw, params, image)),
             median_ms(lambda: dec.decode(want)),
             median_ms(lambda: single.decode(want))]
        line += (f"; sharded encode {t[0]:.3f} ms against Encoder.encode "
                 f"{t[1]:.3f}, sharded decode {t[2]:.3f} against "
                 f"Decoder.decode {t[3]:.3f} (host clock, median of 3)")
    print(line, flush=True)
    return {"encode": e_launch, "decode": d_launch}, got[0]


def rank_main(rank: int, port: str, outdir: str, so: str) -> None:
    """One of phase 15 (v)'s two ranks (``chip_smoke.py --rank R PORT
    OUTDIR LIB``), sharing cuda:0 with the other over gloo: its own 8K
    frame by ``MultiHostEncoder`` (``RANK_BANDS`` bands), its share of
    the single 8K image by ``MultiHostSingleImageEncoder``, its streams
    decoded by ``MultiHostDecoder``; the streams into ``OUTDIR``, the
    rest as one JSON line."""
    import hashlib
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpujpeg_tpu_torch as gj
    from gpujpeg_tpu_torch import _build
    from gpujpeg_tpu_torch.ops import dct, decode, entropy
    from gpujpeg_tpu_torch.parallel import (
        Mesh, MultiHostDecoder, MultiHostEncoder,
        MultiHostSingleImageEncoder, global_mesh, init_distributed)

    existed = os.path.exists(so)
    _build.load_kernels()
    report = {"rank": rank, "library_existed": existed,
              "library": _build.library_path()}
    init_distributed(f"localhost:{port}", num_processes=2, process_id=rank)
    params, image, _ = setup(gj, H8K, W8K)
    img = make_image(H8K, W8K)
    local = [torch.device("cuda", 0)] * RANK_BANDS
    ekern = (dct.fdct_quant, entropy.huffman_blocks, entropy.merge_stuff)
    dkern = (decode.huffman_decode, dct.idct_rgb)

    def counted(kernels, fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        return out, {k.__name__: k.launches for k in kernels}

    enc = MultiHostEncoder(global_mesh(local_devices=local))
    streams, report["frames_launches"] = counted(ekern, lambda: (
        enc.encode_my_frames([np.roll(img, 16 * rank, axis=1)], params,
                             image)))
    single = MultiHostSingleImageEncoder(Mesh([local]))
    data, report["single_launches"] = counted(
        ekern, lambda: single.encode(img, params, image))
    outs, report["decode_launches"] = counted(
        dkern, lambda: MultiHostDecoder(Mesh([local])).decode_my_frames(
            streams))
    for name, blob in (("frame", streams[0]), ("single", data)):
        with open(os.path.join(outdir, f"{name}_{rank}.jpg"), "wb") as f:
            f.write(blob)
    report["decoded_sha256"] = hashlib.sha256(outs[0][0].tobytes()).hexdigest()
    report["world"] = enc.mesh.shape
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps(report), flush=True)


def run_ranks_and_examples(card: str) -> tuple[list, list, str]:
    """(v)'s two ranks and (vi)'s two examples, in four subprocesses
    started together; each must exit 0 within its time. Returns the
    ranks' reports, the examples' outputs and the temporary directory
    with the ranks' streams (the caller removes it)."""
    import socket
    import tempfile
    from gpujpeg_tpu_torch import _build
    root = os.path.dirname(os.path.abspath(__file__))
    so = _build.library_path()
    mtime = os.stat(so).st_mtime_ns
    tmp = tempfile.mkdtemp()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    cmds = [[sys.executable, os.path.abspath(__file__), "--rank", str(r),
             port, tmp, so] for r in range(2)]
    cmds += [[sys.executable, "-m", f"gpujpeg_tpu_torch.examples.{name}"]
             for name in ("sharded_encode", "multihost_video")]
    procs = [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            fail(f"phase 15: {' '.join(c[1:3])} exited {p.returncode}: "
                 f"{err[-2000:]}")
    if os.stat(so).st_mtime_ns != mtime:
        fail("phase 15 (v): a rank rebuilt the kernel library")
    reports = [json.loads(out.strip().splitlines()[-1])
               for out, _ in outs[:2]]
    return reports, [out for out, _ in outs[2:]], tmp


def phase_parallel(gj, img: np.ndarray, data: bytes, card: str) -> dict:
    """Phase 15: band- and frame-sharded encode and decode on meshes that
    repeat cuda:0 (and over distinct cards where there are two or more),
    a failing band, two ranks sharing the card over gloo and the two
    examples; returns the sharded launch counts by kernel row name."""
    import hashlib
    import shutil

    import gpujpeg_tpu_torch.parallel as par
    from gpujpeg_tpu_torch.ops import dct, decode, entropy, pipeline
    from gpujpeg_tpu_torch.ops import preprocess as pre
    from gpujpeg_tpu_torch.stream.reader import JpegParseError

    t_phase = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    params, image, _ = setup(gj, H8K, W8K)
    ri = par.choose_restart_interval(params, image, 4)
    if ri != params.restart_interval:
        fail(f"phase 15: choose_restart_interval over 4 bands gives {ri}, "
             f"expected {params.restart_interval}")
    raw = img.reshape(-1)
    e1 = (dct.fdct_quant, entropy.huffman_blocks, entropy.merge_stuff)
    e0 = (pre.preprocess_planes, dct.fdct_quant_planes,
          entropy.huffman_blocks, entropy.merge_stuff)
    d2 = (decode.huffman_decode, dct.idct_rgb)
    d3 = (decode.huffman_decode, dct.idct_planes, pre.postprocess_planes)
    params_a, image_a = plan_a(gj)
    raw_a = make_raw(gj, img, image_a)
    data_a = gj.Encoder(backend="torch", device="cuda").encode(
        raw_a, params_a, image_a)

    def rows_of(label, counts, names):
        """Route counts -> {kernel row name: {label: launches}}."""
        out = {}
        for k, v in counts.items():
            out.setdefault(names.get(k, k), {})[label] = v
        return out

    sharded: dict = {}

    def add(more):
        for k, v in more.items():
            sharded.setdefault(k, {}).update(v)

    # (i) and (iii): one frame over bands of cuda:0
    mesh4 = par.Mesh([[cuda0] * 4])
    mesh2 = par.Mesh([[cuda0] * 2])
    main, _ = sharded_pair(gj, par, "(i)/(iii) main path", mesh4, raw,
                           params, image, data, e1, d2, card, True)
    a_counts, _ = sharded_pair(gj, par, "(i)/(iii) (a)", mesh2, raw_a,
                               params_a, image_a, data_a, e0, d3, card,
                               False)
    add(rows_of("main path 1x4", {**main["encode"], **main["decode"]}, {}))
    add(rows_of("(a) 1x2", a_counts["encode"], {}))
    add(rows_of("(a) 1x2", a_counts["decode"],
                {"huffman_decode": "huffman_decode[K4 regime (a)]"}))

    # (ii) encode_batch of 4 frames over (2, 2), (iii) its decode_batch
    frames = [np.roll(img, 16 * k, axis=1).reshape(-1) for k in range(4)]
    mesh22 = par.Mesh([[cuda0] * 2, [cuda0] * 2])
    enc = gj.Encoder(backend="torch", device="cuda")
    want = [enc.encode(f, params, image) for f in frames]
    got = []
    b_launch = sharded_count(e1, lambda: got.extend(par.ShardedEncoder(
        mesh22).encode_batch(frames, params, image)), 8,
        "(ii) encode_batch")
    bad = [i for i in range(4) if got[i] != want[i]]
    if bad:
        fail(f"phase 15 (ii): streams {bad} of encode_batch differ from "
             "encode of the same frames")
    dec1 = gj.Decoder(backend="torch", device="cuda")
    want_raw = [dec1.decode(d)[0] for d in want]
    sdec = par.ShardedDecoder(mesh4)
    outs = []
    bd_launch = sharded_count(d2, lambda: outs.extend(
        sdec.decode_batch(want)), 16, "(iii) decode_batch")
    bad = [i for i in range(4) if not np.array_equal(outs[i][0],
                                                     want_raw[i])]
    if bad:
        fail(f"phase 15 (iii): frames {bad} of decode_batch differ from "
             "Decoder.decode of the same streams")
    print(f"phase 15 (ii)/(iii): {card}: encode_batch of 4 main-path frames "
          f"over a (2, 2) mesh of cuda:0 equals encode of each frame, "
          f"launches {b_launch}; decode_batch of those streams over 4 "
          f"bands equals Decoder.decode of each, launches {bd_launch}",
          flush=True)
    add(rows_of("batch 2x2 (4 frames)", b_launch, {}))
    add(rows_of("decode_batch 1x4 (4 frames)", bd_launch, {}))
    del outs, want_raw, frames

    # (iv) a failing band raises from decode and decode_batch
    real = pipeline.huffman_decode
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("gj_huffman_decode: CUDA launch failed "
                               "(injected into band 2)")
        return real(*a, **k)

    pipeline.huffman_decode = failing
    try:
        for what, call in (("decode", lambda: sdec.decode(data)),
                           ("decode_batch",
                            lambda: sdec.decode_batch([want[1], data]))):
            calls.clear()
            try:
                call()
                fail(f"phase 15 (iv): a failing band did not raise from "
                     f"{what}")
            except RuntimeError as e:
                if "injected" not in str(e):
                    raise
    finally:
        pipeline.huffman_decode = real
    try:
        sdec.decode_batch([data, b"\xff\xd8garbage"])
        fail("phase 15 (iv): a corrupt stream in a batch did not raise")
    except JpegParseError:
        pass
    after, _ = sdec.decode(want[1])
    if not np.array_equal(after, dec1.decode(want[1])[0]):
        fail("phase 15 (iv): the decode after the failures differs")
    print("phase 15 (iv): a D1 failing in band 2 raised from decode and "
          "from decode_batch, a corrupt stream raised JpegParseError from "
          "decode_batch, and a decode after them equals Decoder.decode",
          flush=True)
    del sdec, after
    torch.cuda.empty_cache()

    # (vii) distinct cards, where there are two or more
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        n = 4 if n_cards >= 4 else 2
        cards = par.Mesh([[torch.device("cuda", i) for i in range(n)]])
        sharded_pair(gj, par, f"(vii) main path over {n} cards", cards, raw,
                     params, image, data, e1, d2, card, True)
        sharded_pair(gj, par, "(vii) (a) over 2 cards",
                     par.Mesh([[torch.device("cuda", i) for i in range(2)]]),
                     raw_a, params_a, image_a, data_a, e0, d3, card, False)
    else:
        print(f"phase 15 (vii): {n_cards} CUDA device: only meshes that "
              "repeat cuda:0 ran; no two distinct cards were tried",
              flush=True)

    # (v) two ranks sharing cuda:0 over gloo, (vi) the examples
    reports, ex_outs, tmp = run_ranks_and_examples(card)
    try:
        for r, rep in enumerate(reports):
            if not rep["library_existed"]:
                fail(f"phase 15 (v): rank {r} found no built library")
            with open(os.path.join(tmp, f"frame_{r}.jpg"), "rb") as f:
                frame_stream = f.read()
            with open(os.path.join(tmp, f"single_{r}.jpg"), "rb") as f:
                single_stream = f.read()
            if frame_stream != want[r]:
                fail(f"phase 15 (v): rank {r}'s frame stream differs from "
                     "Encoder.encode of its frame")
            if single_stream != data:
                fail(f"phase 15 (v): rank {r}'s single-image stream "
                     "differs from Encoder.encode of the image")
            sha = hashlib.sha256(dec1.decode(frame_stream)[0].tobytes())
            if rep["decoded_sha256"] != sha.hexdigest():
                fail(f"phase 15 (v): rank {r}'s decode differs from "
                     "Decoder.decode of its stream")
            for key in ("frames_launches", "single_launches",
                        "decode_launches"):
                if set(rep[key].values()) != {RANK_BANDS}:
                    fail(f"phase 15 (v): rank {r} {key} {rep[key]}, "
                         f"expected {RANK_BANDS} each (one a band)")
    finally:
        shutil.rmtree(tmp)
    print(f"phase 15 (v): {card}: two ranks on cuda:0 over gloo (global "
          f"mesh {reports[0]['world']}, {RANK_BANDS} bands of cuda:0 a "
          f"rank): each rank's 8K frame stream "
          f"equals Encoder.encode of its frame, both ranks' single-image "
          f"streams ({2 * RANK_BANDS} bands) equal Encoder.encode of the "
          f"image, their decodes equal Decoder.decode; launches rank 0 "
          f"{reports[0]['frames_launches']}, "
          f"{reports[0]['single_launches']}, "
          f"{reports[0]['decode_launches']}; both loaded "
          f"{os.path.basename(reports[0]['library'])} and neither rebuilt "
          "it", flush=True)
    ex_checks = (("sharded_encode", "equal to one device's stream: True"),
                 ("multihost_video", "equal to one device's streams: True"))
    for (name, needle), out in zip(ex_checks, ex_outs):
        if needle not in out:
            fail(f"phase 15 (vi): examples/{name}.py: {out[-2000:]}")
        print(f"phase 15 (vi): {card}: examples/{name}.py: "
              + " | ".join(out.strip().splitlines()), flush=True)
    for key, label in (("frames_launches", "(v) rank 0 frame"),
                       ("single_launches", "(v) rank 0 single image"),
                       ("decode_launches", "(v) rank 0 decode")):
        add(rows_of(label, reports[0][key], {}))
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sharded


# ---------------------------------------------------------------------------
# Phase 16: the bench entry points
# ---------------------------------------------------------------------------

#: phase 16: the depth of the bench run in a subprocess
BENCH16_ITERS = 6


def check_bench_line(proc, card: str) -> dict:
    """Wait for phase 16's ``tools.bench`` subprocess; fail unless it
    exited 0 with every key of the line, a number for every time and the
    route gate's launches; its line."""
    from gpujpeg_tpu_torch.tools import bench
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"phase 16: tools.bench exited {proc.returncode}: {err[-3000:]}")
    line = json.loads(out.strip().splitlines()[-1])
    if tuple(line) != bench.LINE_KEYS:
        fail(f"phase 16: tools.bench's line has keys {list(line)}, expected "
             f"{list(bench.LINE_KEYS)}")
    times = [k for k in bench.LINE_KEYS if k.endswith(("_ms", "_s"))
             or k in ("value", "vs_baseline")]
    if not all(isinstance(line[k], float) and line[k] > 0 for k in times):
        fail(f"phase 16: tools.bench's times {[line[k] for k in times]}")
    runs = line["launches"]["runs"]
    want = {k.__name__: n * runs for k, n in {
        **bench.ENCODE_ROUTE, **bench.DECODE_ROUTE}.items()}
    want["runs"] = runs
    if line["launches"] != want or line["card"] != card:
        fail(f"phase 16: tools.bench's launches {line['launches']} "
             f"(expected {want}) or card {line['card']!r}")
    for s in err.splitlines():
        if s.startswith(("route gate", "first call", "round-trip",
                         "cross-check")):
            print(f"phase 16: tools.bench: {s}", flush=True)
    return line


def phase_bench(gj, card: str) -> dict:
    """Phase 16: ``python -m gpujpeg_tpu_torch.tools.bench`` in a
    subprocess (``BENCH_ITERS`` = :data:`BENCH16_ITERS`; its line's keys,
    times and route launches checked) beside, in this process, the first
    16K encode and decode on the card (``tools.bench_suite.bench_res("16K",
    3)``) with the launch counts set to 0 before it: each kernel of the
    route launched 5 times (the first call, a warm-up and 3 runs), the
    first encode's peak memory within ``Encoder.max_memory``, the stream
    held to golden by :func:`coefficient_check` (E1's coefficients under
    the tie rule, the stream equal to the golden entropy coder's on
    them), and ``Decoder.decode`` of it to the stream's colour space
    within 1 of the golden decoder's (the IDCT rule before the colour
    transform). Returns the 16K run's launches."""
    from gpujpeg_tpu_torch.ops.pipeline import EncContext
    from gpujpeg_tpu_torch.stream.reader import read_image
    from gpujpeg_tpu_torch.tools import bench, bench_suite

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpujpeg_tpu_torch.tools.bench"], cwd=root,
        env=dict(os.environ, BENCH_ITERS=str(BENCH16_ITERS)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        H, W = bench_suite.RES["16K"]
        img = make_image(H, W)
        route = {**bench.ENCODE_ROUTE, **bench.DECODE_ROUTE}
        for k in route:
            k.launches = 0
        t0 = time.perf_counter()
        row, data = bench_suite.bench_res("16K", 3, img=img)
        res_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in route}
        want = {k.__name__: 5 * n for k, n in route.items()}
        if launches != want:
            fail(f"phase 16: 16K launches {launches}, expected {want}")
        if row["encode_peak_bytes"] > row["max_memory"]:
            fail(f"phase 16: the 16K encode's peak {row['encode_peak_bytes']} "
                 f"B passes Encoder.max_memory {row['max_memory']} B")
        torch.cuda.empty_cache()

        params, image, plan = setup(gj, H, W)
        if params.restart_interval != row["restart_interval"]:
            fail(f"phase 16: interval {params.restart_interval}, the suite's "
                 f"{row['restart_interval']}")
        ctx = EncContext(plan, *encode_tables(params.quality),
                         torch.device("cuda"))
        n_ties, tie_segs = coefficient_check(
            gj, ctx, img.reshape(-1), params, image, data, "phase 16: 16K")
        del ctx
        torch.cuda.empty_cache()
        cs = read_image(data).color_space
        outs = {}
        for backend, ocs in (("torch", cs), ("golden", cs),
                             ("torch", gj.ColorSpace.RGB)):
            dd = gj.Decoder(backend=backend, device="cuda")
            dd.set_output_format(ocs, gj.PixelFormat.PF_444_U8_P012)
            outs[backend, ocs] = dd.decode(data)[0].reshape(H, W, 3)
        d_id = np.abs(outs["torch", cs].astype(np.int16)
                      - outs["golden", cs])
        p_t = psnr(outs["torch", gj.ColorSpace.RGB], img)
        del outs
        print(f"phase 16: 16K {W}x{H} (interval {row['restart_interval']}, "
              f"{plan.n_segments} segments, {len(data)} bytes), first call "
              f"to the end of bench_res {res_s:.1f} s: launches {launches}; "
              f"{card}: encode {row['encode_device_ms']:.4f} ms, decode "
              f"{row['decode_device_ms']:.4f} ms (CUDA events, 3 runs); "
              f"the first encode's peak {row['encode_peak_bytes']} B "
              f"({row['encode_peak_bytes'] / (W * H):.2f} B a pixel) within "
              f"Encoder.max_memory {row['max_memory']} B; equal to the "
              f"golden entropy coder's stream of the kernels' coefficients, "
              f"{n_ties} of those at .5 ties of the golden DCT in "
              f"{len(tie_segs)} segments; decoded, {int((d_id != 0).sum())} "
              f"values differ from the golden decoder's before the colour "
              f"transform (max |d| {int(d_id.max())}); PSNR {p_t:.4f} dB",
              flush=True)
        if d_id.max() > 1:
            fail("phase 16: the 16K decode differs from golden by more than "
                 "1 before the colour transform")
        del d_id, img
        line = check_bench_line(proc, card)
    finally:
        if proc.poll() is None:   # with the first-call processes it started
            os.killpg(proc.pid, 9)
            proc.wait()
    print(f"phase 16: tools.bench (BENCH_ITERS={BENCH16_ITERS}, run beside "
          f"the 16K check, so its times are not measurements): "
          f"{json.dumps(line)}", flush=True)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 17: the soak on the card (tools.soak)
# ---------------------------------------------------------------------------

#: phase 17's fixed cases, (seed, index): 80x8 and 96x160 RGB 4:4:4 on
#: the E1 + D2 routes
SOAK17_FIXED = ((25, 0), (25, 2))
#: then this many threads, each with its own coders, on as many cases
#: each of this seed (cases 0-7 of seed 30: E1 + D2 and E0 + E1p + D2p +
#: D3), so every kernel of the encode and decode routes runs
SOAK17_THREADS, SOAK17_THREAD_CASES, SOAK17_THREAD_SEED = 2, 4, 30


def phase_soak(card: str) -> dict:
    """Phase 17: ``tools.soak`` on the card, with the route's launch counts
    set to 0 before it: the cases of :data:`SOAK17_FIXED` in turn, then
    :data:`SOAK17_THREADS` threads on :data:`SOAK17_THREAD_CASES` cases
    each; each case held to the CPU route and the golden coder, its
    corrupt streams decoded (``tools.soak``'s rules). Fails on any failing
    case and where a kernel of the encode or decode routes did not
    launch; prints the phase's time, its cases a second and its ``oom``
    count. Returns the launches."""
    from gpujpeg_tpu_torch.ops import dct, decode, entropy, preprocess as pre
    from gpujpeg_tpu_torch.tools import soak
    kernels = (pre.preprocess_planes, dct.fdct_quant_planes, dct.fdct_quant,
               entropy.huffman_blocks, entropy.merge_stuff,
               decode.huffman_decode, dct.idct_rgb, dct.idct_planes,
               pre.postprocess_planes)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runs = [soak.soak(seed, "cuda", index=i) for seed, i in SOAK17_FIXED]
    runs.append(soak.soak(SOAK17_THREAD_SEED, "cuda",
                          cases=SOAK17_THREADS * SOAK17_THREAD_CASES,
                          threads=SOAK17_THREADS))
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    n, oom = sum(r["cases"] for r in runs), sum(r["oom"] for r in runs)
    lines = [s for r in runs for s in r["lines"]]
    outcomes = sum((r["outcomes"] for r in runs), soak.Counter())
    print(f"phase 17: {card}: soak of {n} cases ((seed, index) "
          f"{SOAK17_FIXED} in turn, "
          f"then {SOAK17_THREADS} threads x {SOAK17_THREAD_CASES} of seed "
          f"{SOAK17_THREAD_SEED}) in {dt:.1f} s, {n / dt:.3f} cases/s, "
          f"{len(lines)} failure lines, {oom} oom; corrupt streams "
          f"{dict(sorted(outcomes.items()))}; launches {launches}",
          flush=True)
    if lines or n != len(SOAK17_FIXED) + SOAK17_THREADS * SOAK17_THREAD_CASES:
        fail(f"phase 17: the soak failed: {lines[:5]}")
    if min(launches.values()) < 1:
        fail(f"phase 17: a kernel of the routes did not launch: {launches}")
    print(f"phase 17: {dt:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 18: the lane decoder D1L on the 12 MP camera frame
# ---------------------------------------------------------------------------

#: phase 18's camera frame: height, width and quality (4:2:0 interleaved,
#: no restart markers: cjpeg's defaults at the 12 MP 4:3 size)
PHOTO = (3024, 4032, 92)
#: the 12 MP frame's 8x8 blocks
PHOTO_BLOCKS = 285_768


def phase_lanes(gj, card: str) -> tuple[dict, dict]:
    """Phase 18: D1L on the card's rows of the 12 MP camera frame
    (:data:`PHOTO`) against its plain form, rounds included, and D1;
    ``decode_to_device`` with the launch counters set to 0 just before
    it; the kernel timed beside its plain form and the bound; then the
    flat and tiled frames against D1, their rounds and times printed.
    Returns (the kernel's row, its launches on the main path)."""
    from gpujpeg_tpu_torch.ops import decode
    t_phase = time.perf_counter()
    H, W, q = PHOTO
    image = gj.ImageParameters(width=W, height=H,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)
    params = gj.Parameters(quality=q, restart_interval=0, interleaved=True) \
        .with_chroma_subsampling(420)
    enc = gj.Encoder(backend="golden")

    def parts(data: bytes):
        """(decode context, rows on the card, D1's operands)."""
        _, plan, _, ctx, rows = decode_parts(data, image, "cuda")
        if not ctx.lanes or plan.n_segments != 1 \
                or plan.n_blocks != PHOTO_BLOCKS:
            fail(f"phase 18: the {W}x{H} stream is not one segment of "
                 f"{PHOTO_BLOCKS} blocks on the lane route")
        t = ctx.tables
        return ctx, rows, (rows, ctx.seg_start, ctx.seg_count,
                           ctx.block_comp, t.wide, t.maxcode, t.delta,
                           t.huffval, t.dc_slot, t.ac_slot)

    data = enc.encode(make_image(H, W).reshape(-1), params, image)
    ctx, rows, d1 = parts(data)
    t = ctx.tables
    geo = ctx.geo
    f = decode._geometry_fields(geo)
    coeff = ctx.coefficients(rows)
    rounds = int(ctx.rounds.item())
    (coeff_p, rounds_p), plain_ms = cuda_ms_once(
        lambda: decode.huffman_lanes_plain(
            rows, geo, ctx.n_blocks, t.wide, t.maxcode, t.delta, t.huffval,
            t.dc_slot, t.ac_slot))
    coeff_1 = decode.huffman_decode(*d1)
    bad_p = int((coeff != coeff_p).sum())
    bad_1 = int((coeff != coeff_1).sum())
    print(f"phase 18: D1L huffman_lanes {W}x{H} Q{q} 4:2:0 interleaved, no "
          f"restart markers: {len(data)} B, {ctx.n_blocks} blocks, "
          f"{f['n_lanes']} lanes of {f['lane_bits']} bits, {rounds} rounds "
          f"(plain {int(rounds_p.item())}); {bad_p} coefficients differ from "
          f"the plain version on the same rows and geometry, {bad_1} from "
          f"D1's", flush=True)
    if bad_p or bad_1 or rounds != int(rounds_p.item()):
        fail("phase 18: D1L disagrees with its plain version or D1")
    del coeff_p, coeff_1

    dec = gj.Decoder(backend="torch", device="cuda")
    gold = gj.Decoder(backend="golden")
    for d in (dec, gold):
        d.set_output_format(gj.ColorSpace.RGB, gj.PixelFormat.PF_444_U8_P012)
    raw, _ = dec.decode(data)
    want, _ = gold.decode(data)
    torch.cuda.synchronize()
    decode.huffman_lanes.launches = decode.huffman_lanes.lanes = 0
    decode.huffman_decode.launches = 0
    on_card, _ = dec.decode_to_device(data)
    torch.cuda.synchronize()
    launches = {"huffman_lanes": decode.huffman_lanes.launches,
                "lanes": decode.huffman_lanes.lanes,
                "huffman_decode": decode.huffman_decode.launches}
    gap = int(np.abs(raw.astype(np.int16) - want.astype(np.int16)).max())
    same = np.array_equal(on_card.cpu().numpy().reshape(-1), raw.reshape(-1))
    print(f"phase 18: decode_to_device of the stream: launches {launches}; "
          f"{'equal to' if same else 'DIFFERS from'} decode's frame, which "
          f"is within {gap} of the golden decoder's", flush=True)
    if launches != {"huffman_lanes": 1, "lanes": f["n_lanes"],
                    "huffman_decode": 0}:
        fail("phase 18: decode_to_device did not take D1L once")
    if not same or gap > PIXEL_STEP:
        fail(f"phase 18: the frame differs from decode's or the golden "
             f"decoder's by more than {PIXEL_STEP}")
    del dec, gold, raw, want, on_card

    ms = cuda_ms(lambda: ctx.coefficients(rows), 10)
    bnd = bound(int(f["bits"].sum()) // 8 + ctx.n_blocks * 64 * 2)
    print(f"phase 18: {card}: huffman_lanes {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}: the scan read once, the coefficients "
          f"written once at 2 B)", flush=True)
    row = {"name": "huffman_lanes", "route": "cuda",
           "source": "gpujpeg_tpu_torch/csrc/huffman_lanes.cu",
           "replaces": None, "launches": 0, "max_abs_err": 0, "ms": ms,
           "plain_ms": plain_ms, **bnd, "library_ms": None}
    del ctx, rows, d1, coeff

    tile = np.random.default_rng(18).integers(
        120, 136, (16, 16, 3), dtype=np.uint8)
    for what, frame in (("flat", np.full((H, W, 3), 77, np.uint8)),
                        ("tiled", np.tile(tile, (H // 16, W // 16, 1)))):
        data = enc.encode(frame.reshape(-1), params, image)
        ctx, rows, d1 = parts(data)
        f = decode._geometry_fields(ctx.geo)
        coeff, first_ms = cuda_ms_once(lambda: ctx.coefficients(rows))
        rounds = int(ctx.rounds.item())
        ms = cuda_ms(lambda: ctx.coefficients(rows), 3)
        coeff_1, d1_ms = cuda_ms_once(lambda: decode.huffman_decode(*d1))
        bad = int((coeff != coeff_1).sum())
        print(f"phase 18: {card}: {what} frame, {len(data)} B, "
              f"{f['n_lanes']} lanes: {rounds} rounds (the bound "
              f"{f['max_lanes']}), huffman_lanes {ms:.4f} ms (first call "
              f"{first_ms:.4f}), D1 {d1_ms:.4f} ms; {bad} coefficients "
              f"differ from D1's", flush=True)
        if bad or not 1 <= rounds <= f["max_lanes"]:
            fail(f"phase 18: D1L on the {what} frame disagrees with D1 or "
                 "passes its bound on the rounds")
        del ctx, rows, d1, coeff, coeff_1
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row, {"huffman_lanes": launches["huffman_lanes"]}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpujpeg_tpu_torch as gj
    from gpujpeg_tpu_torch import _build
    from gpujpeg_tpu_torch.ops.pipeline import EncContext, upload_rgb
    from gpujpeg_tpu_torch.tools import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(torch.device("cuda", 0))
    print(f"phase 1: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    img = make_image(H8K, W8K)
    params, image, plan = setup(gj, H8K, W8K)
    if params.restart_interval != 32:
        fail(f"restart interval {params.restart_interval}, expected 32")
    ctx = EncContext(plan, *encode_tables(params.quality),
                     torch.device("cuda"))
    rgb = upload_rgb(img, plan, ctx.device)
    rows = phase_kernels(ctx, rgb)
    del ctx, rgb
    torch.cuda.empty_cache()

    launches, data = phase_encode(gj, img, params, image, plan, card)
    torch.cuda.empty_cache()
    rows += phase_decode_kernels(gj, data, card)
    torch.cuda.empty_cache()
    launches.update(phase_decode(gj, img, data, card))
    torch.cuda.empty_cache()

    configs = general_configs(gj, img)
    rows += phase_general_kernels(gj, img, configs, card)
    launches_a = phase_general_encode(gj, configs, card)
    launches.update({k: launches_a[k] for k in ("preprocess_planes",
                                                "fdct_quant_planes")})
    phase_small(gj)

    streams = decode_streams(gj, img, configs)
    del configs
    krows, gold = phase_general_decode_kernels(gj, streams, data, card)
    rows += krows
    dl = phase_general_decode(gj, img, streams, gold, card)
    f4_check(gj, "main path", data, params, image, card)
    f4_check(gj, "(a)", streams["a"], *plan_a(gj), card)
    del streams, gold
    launches.update({
        "idct_planes": dl["a"]["idct_planes"],
        "postprocess_planes": dl["a"]["postprocess_planes"],
        "huffman_decode[K4 regime (a)]": dl["a"]["huffman_decode"],
        "huffman_decode[K5 regime (e)]": dl["e"]["huffman_decode"]})
    phase_small_decode(gj)
    srows, slaunches = phase_stage1(gj, img, card)
    rows += srows
    launches.update(slaunches)
    batch_rows = phase_batch(gj, img, data, card)
    sharded = phase_parallel(gj, img, data, card)
    bench16 = phase_bench(gj, card)
    soak17 = phase_soak(card)
    lrow, llaunches = phase_lanes(gj, card)
    rows.append(lrow)
    launches.update(llaunches)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["sharded_launches"] = sharded.get(r["name"], {})
        r["bench16k_launches"] = bench16.get(r["name"], 0)
        r["soak_launches"] = soak17.get(r["name"].split("[")[0], 0)
    print(json.dumps({"batch": batch_rows}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--rank"]:
            rank_main(int(sys.argv[2]), *sys.argv[3:6])
        else:
            main()
    except CheckError as e:
        fail(str(e))
