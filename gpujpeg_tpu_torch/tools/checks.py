"""The comparison rules that hold the card's streams and decodes to the
CPU route and the golden coder, shared by ``chip_smoke.py`` and
:mod:`.soak`. Each check raises :class:`CheckError` where a rule is
broken and returns what it counted.

* **E1's tie rule.** Two float32 evaluations of one DCT quotient (the
  card's kernel and the CPU's plain version) each lie within eps =
  :data:`F32_DOT_REL` * (x @ |M| + |b|) / q of the float64 value, so they
  may round apart, by 1, only where the float64 quotient lies within
  :data:`F32_EVALS` * eps of .5 (:func:`golden_quotients`,
  :func:`tie_segments`). Given equal coefficients the entropy stage is
  exact: two streams of one plan may differ only in restart segments
  that hold such a tie (:func:`differing_segments`, :func:`card_vs_cpu`).
* **The IDCT rule.** Decoded coefficients are exact; pixels may differ
  by 1 at .5 ties of the float64 IDCT, and after the BT.601 inverse one
  step can move a byte by 2 (:data:`PIXEL_STEP`, :func:`decode_pair`).
"""
from __future__ import annotations

import numpy as np
import torch

#: |frac(q64) - .5| below which a float32 DCT may round either way
#: (the fixed width used against golden before the per-value bound)
TIE_EPS = 1e-4
#: relative error bound of a 64-term float32 dot product summed in any
#: order, with the float32 rounding of its operator and the bias
#: subtraction: (64 + 2) * 2**-24 < 2**-17. It also bounds E1's separable
#: form: a row pass and a column pass of 8 terms, each with its factor's
#: float32 rounding, stay under about 20 * 2**-24 * (x @ |M| + |b|),
#: since |D8| (x) |D8| = |M| (Kronecker product of the 8x8 factor), and the
#: bias subtraction adds one rounding more.
F32_DOT_REL = 2.0 ** -17
#: two float32 evaluations of one quotient (E1's kernel and its plain
#: version, the card and the CPU) each lie within eps = F32_DOT_REL *
#: (x @ |M| + |b|) / q of the float64 value, so they can round apart
#: only where the float64 quotient lies within 2 * eps of .5: the
#: per-coefficient tie rule
F32_EVALS = 2
#: the most two IDCT variants' output bytes may differ after the colour
#: transform (1 at a tie of the planes, 2 after the BT.601 inverse)
PIXEL_STEP = 2


class CheckError(Exception):
    """A comparison rule is broken; the message says where."""


def segment_bytes(info) -> list[bytes]:
    """The entropy bytes of every restart segment of a parsed stream, in
    scan order."""
    return [bytes(s.data[lo:hi]) for s in info.scans
            for lo, hi in s.segments]


def golden_quotients(raw, image, plan, quant_zz):
    """(y64, eps) in scan order, each (NB, 64) float64: the quantised DCT
    values by the golden coder's host preprocess and float64 DCT (the
    golden coefficients are their ``rint``), and a bound on the error of
    any float32 evaluation of them, ``F32_DOT_REL * (x @ |M| + |b|)``:
    the width of the .5 tie in which a float32 DCT may round either
    way."""
    from ..ops.blocks import plane_to_blocks
    from ..ops.preprocess import preprocess
    from ..tables import fdct_quant_matrix
    planes = preprocess(raw, image, plan, np)
    y64, eps = [], []
    for c in plan.components:
        M, b = fdct_quant_matrix(quant_zz[c.quant_table_index])
        x = plane_to_blocks(planes[c.index], np).astype(np.float64)
        y64.append(x @ M - b)
        eps.append(F32_DOT_REL * (x @ np.abs(M) + np.abs(b)))
    return (np.concatenate(y64)[plan.block_plane_idx],
            np.concatenate(eps)[plan.block_plane_idx])


def tie_segments(plan, coeff_a, coeff_b, y64, what: str, eps=TIE_EPS):
    """(coefficients that differ, segments that hold one) between two
    (NB, 64) scan-order coefficient arrays; raises unless every
    difference is 1 at a .5 tie of the float64 value ``y64``: within
    ``eps`` (a number, or an (NB, 64) array of bounds) of .5."""
    diff = coeff_a != coeff_b
    if diff.any():
        far = np.abs(np.abs(y64[diff] - np.floor(y64[diff])) - 0.5)
        if np.abs(coeff_a - coeff_b).max() > 1 \
                or (far > (eps[diff] if np.ndim(eps) else eps)).any():
            raise CheckError(f"{what}: coefficients differ beyond .5 ties")
    return int(diff.sum()), set(
        plan.block_segment[np.nonzero(diff.any(axis=1))[0]].tolist())


def differing_segments(plan, data_a: bytes, data_b: bytes,
                       skip: set) -> list[int]:
    """Restart segments outside ``skip`` whose bytes differ between two
    streams of one plan; raises if the segment counts differ."""
    from ..stream.reader import read_image
    seg_a = segment_bytes(read_image(data_a))
    seg_b = segment_bytes(read_image(data_b))
    if len(seg_a) != len(seg_b) or len(seg_a) != plan.n_segments:
        raise CheckError("segment counts differ between two streams of one "
                         "plan")
    return [s for s in range(plan.n_segments)
            if s not in skip and seg_a[s] != seg_b[s]]


def context(params, image, device="cuda"):
    """The device encode's context of ``params`` and ``image`` on
    ``device``, with the golden coder's tables."""
    from ..ops.pipeline import EncContext
    from ..plan import make_plan
    from ..tables import encode_tables
    return EncContext(make_plan(params, image),
                      *encode_tables(params.quality), torch.device(device))


def card_vs_cpu(raw, params, image, a: bytes, b: bytes,
                device="cuda") -> str:
    """Two streams of one frame, ``a`` encoded on ``device`` and ``b``
    through the CPU plain path: raises unless their coefficients differ
    only at .5 ties (both float32: within ``F32_EVALS * eps``) and the
    streams only in segments that hold one, naming the first segments
    that differ otherwise. Returns a summary."""
    from ..tables import encode_tables
    ca, cb = context(params, image, device), context(params, image, "cpu")
    quant_zz, _ = encode_tables(params.quality)
    y64, eps = golden_quotients(raw, image, ca.plan, quant_zz)
    what = f"{image.width}x{image.height} {device} vs CPU"
    n_ties, tie_segs = tie_segments(
        ca.plan, ca.coefficients(ca.upload(raw)).cpu().numpy(),
        cb.coefficients(cb.upload(raw)).numpy(), y64, what, F32_EVALS * eps)
    bad = differing_segments(ca.plan, a, b, tie_segs)
    if bad:
        raise CheckError(f"{what}: the streams differ beyond .5 ties in "
                         f"segments {bad[:10]}")
    return (f"the {device} stream differs from the CPU plain path's in "
            f"{len(tie_segs)} segments with {n_ties} coefficients at .5 "
            f"ties, in no other")


def decode_parts(data: bytes, out_image, device):
    """(info, plan, golden decode inputs, decode context, rows on
    ``device``) of a stream decoded to ``out_image``."""
    from ..models.decoder import huffman_maps, plan_from_info
    from ..ops.pipeline import dec_context
    from ..stream.reader import read_image
    info = read_image(data)
    plan, scan_data, segs = plan_from_info(info)
    dc, ac = huffman_maps(info)
    ctx = dec_context({}, plan, info, dc, ac, out_image, torch.device(device))
    rows = torch.from_numpy(ctx.rows(scan_data, segs)).to(device)
    return info, plan, (plan, scan_data, segs, dc, ac), ctx, rows


def decode_pair(data: bytes, out_image, got: np.ndarray, device) -> int:
    """The IDCT rule between ``got``, ``data`` decoded to ``out_image`` on
    ``device``, and the CPU route's decode of it (the kernels' plain
    versions, D1 run once for both checks): D1's coefficients on
    ``device`` equal the plain D1's, and the bytes differ by at most
    :data:`PIXEL_STEP`. Raises otherwise (``JpegParseError`` where the
    CPU route does); returns the largest difference."""
    _, _, _, ctx, rows = decode_parts(data, out_image, "cpu")
    coeff = ctx.coefficients(rows)
    want = ctx.pixels(coeff).numpy()
    _, _, _, ctx_d, rows_d = decode_parts(data, out_image, device)
    n = int((ctx_d.coefficients(rows_d).cpu() != coeff).sum())
    if n:
        raise CheckError(f"{n} decoded coefficients differ between {device} "
                         "and the CPU route")
    got = np.asarray(got).reshape(-1)
    if got.shape != want.shape:
        raise CheckError(f"decode sizes {got.size} and {want.size} differ")
    d = int(np.abs(got.astype(np.int16) - want).max(initial=0))
    if d > PIXEL_STEP:
        raise CheckError(f"decoded bytes differ by {d} between {device} and "
                         f"the CPU route (allowed {PIXEL_STEP})")
    return d
