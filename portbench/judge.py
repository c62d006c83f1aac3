"""The comparison that decides ``correct``: the program's outputs against
the plain reference (:mod:`portbench.reference`), after the window.

Two numbers, each the worst over what the window produced:

* ``enc_worst_miss``: each distinct stream kept from the encode phase
  is decoded by the reference (its own markers, tables and
  entropy coding), and each coefficient, scaled by the stream's
  quantisation table over the deployment's, is set against the float64
  quotient ``q`` of the same frame: ``max(0, |c * Qs / Qr - q| - 1/2)``,
  in units of the deployment's table. Rounding to nearest reads 0; a
  float32 DCT that rounds a quotient within its error of .5 the other
  way reads that error. A stream or segment that does not decode reads
  as coefficients of 0.
* ``dec_worst_miss``: each decoded frame kept from the decode phase
  against the reference's float64 decode of the same stream. Each
  component sample is rounded to nearest, or to its other neighbour at
  a cost: its float64 value's distance from .5. Each output byte reads
  the least cost of the roundings (of the samples behind it, through the
  integer colour transform and packing) that give the byte the program
  returned, 1 where none does. A float32 IDCT reads its error at the
  samples it rounds the other way (an exact .5 reads 0); a wrong byte
  reads 1; a frame of the wrong size reads 1.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import codec, pixels
from .reference.geometry import PIXEL_FORMATS, Geometry, raw_size

#: segments of one call of the lockstep decoder (bounds its temporaries;
#: it cuts a segment longer than ``codec.CHUNK_BITS`` into more lanes only
#: without restart markers, one segment a scan)
DECODE_LANES = 1 << 18


class Deployment:
    """A configuration's geometry and the reference's view of its
    frames: planes, quotients, coefficients and decoded output."""

    def __init__(self, cfg: dict, geo: Geometry):
        self.cfg = cfg
        self.geo = geo
        self.quant = codec.quant_tables(geo, cfg["quality"])
        #: the reference decoder's lanes, rounds and steps, summed
        self.counts = {"lanes": 0, "rounds": 0, "steps": 0}

    def planes(self, raw: torch.Tensor) -> list:
        c = self.cfg
        return pixels.to_planes(raw, self.geo, c["pixel_format"],
                                c["color_space"], c["color_space_internal"])

    def stream(self, raw: torch.Tensor, precision: str = "float64") -> bytes:
        return codec.encode(self.planes(raw), self.geo, self.cfg["quality"],
                            precision)

    def output(self, coeff: torch.Tensor, quant=None,
               precision: str = "float64") -> torch.Tensor:
        """Scan-order coefficients -> the flat output frame."""
        c = self.cfg
        planes = codec.to_planes(coeff, self.geo,
                                 self.quant if quant is None else quant,
                                 precision)
        return pixels.from_planes(planes, self.geo, c["output_pixel_format"],
                                  c["output_color_space"],
                                  c["color_space_internal"])

    def decode(self, streams: list, device) -> list:
        """Reference decode of whole streams: (coefficients, stream's
        tables) of each, or None where the stream does not parse."""
        parsed = []
        for s in streams:
            try:
                parsed.append(codec.parse(s, self.geo))
            except codec.StreamError:
                parsed.append(None)
        good = [p for p in parsed if p is not None]
        per = max(1, DECODE_LANES // max(1, self.geo.n_segments))
        coeffs = []
        for i in range(0, len(good), per):
            coeff, _, counts = codec.decode_segments(good[i:i + per],
                                                     self.geo, device)
            coeffs += list(coeff)
            for key, v in counts.items():
                self.counts[key] += v
        it = iter(coeffs)
        return [None if p is None else (next(it), p.quant) for p in parsed]


def worst_miss(dep: Deployment, streams: list, frames: dict, device) -> float:
    """``enc_worst_miss`` of ``streams`` [(pool index, bytes)]; ``frames``
    maps a pool index to its raw frame."""
    geo = dep.geo
    comp = torch.as_tensor(geo.block_comp, device=device)
    worst = 0.0
    q_of = {}
    for (idx, _), got in zip(streams, dep.decode([s for _, s in streams],
                                                 device)):
        if idx not in q_of:
            q_of[idx] = codec.quotients(dep.planes(frames[idx].to(device)),
                                        geo, dep.quant)
        q = q_of[idx]
        if got is None:
            c = torch.zeros_like(q)
        else:
            coeff, qs = got
            scale = torch.as_tensor(np.stack([qs[i] / dep.quant[i]
                                              for i in range(len(qs))]),
                                    device=device)[comp]
            c = coeff.to(torch.float64) * scale
        worst = max(worst, float(((c - q).abs() - 0.5).clamp(min=0).max()))
    return worst


def _candidates(dep: Deployment, coeff: torch.Tensor):
    """For each of the 2**n ways to round the n components' samples (to
    nearest, or to the other neighbour), the output frame it gives and,
    for each byte, the cost of the samples behind it: the largest
    distance from .5 of a sample rounded the other way (0 for none)."""
    cfg, geo = dep.cfg, dep.geo
    xs = codec.sample_values(coeff, geo, dep.quant)
    near = [torch.clamp(torch.round(x), 0, 255) for x in xs]
    other = [torch.clamp(torch.where(torch.round(x) == torch.floor(x),
                                     torch.floor(x) + 1, torch.floor(x)),
                         0, 255) for x in xs]
    dist = [((x - torch.floor(x)) - 0.5).abs().to(torch.float32) for x in xs]
    H, W = geo.height, geo.width
    pix = torch.arange(H * W, device=coeff.device).reshape(H, W)
    nch = len(PIXEL_FORMATS[cfg["output_pixel_format"]][2])
    byte_pixel = pixels.pack([pix] * nch, W, H, cfg["output_pixel_format"])
    n = len(geo.components)
    for k in range(2 ** n):
        flip = [bool(k >> c & 1) for c in range(n)]
        planes = [(o if f else r).to(torch.uint8)
                  for r, o, f in zip(near, other, flip)]
        cost = torch.zeros(H, W, dtype=torch.float32, device=coeff.device)
        for c, f in zip(geo.components, flip):
            if f:
                cost = torch.maximum(cost, pixels.full_res(dist[c.index],
                                                           c, geo))
        out = pixels.from_planes(planes, geo, cfg["output_pixel_format"],
                                 cfg["output_color_space"],
                                 cfg["color_space_internal"])
        yield out, cost.reshape(-1)[byte_pixel.clamp(max=H * W - 1)]


def decode_miss(dep: Deployment, outputs: list, frames: dict,
                device) -> float:
    """``dec_worst_miss`` of ``outputs`` [(pool index, frame as a flat
    uint8 array or tensor)], each decoded from the reference's stream of
    ``frames[index]``."""
    cfg = dep.cfg
    size = raw_size(cfg["width"], cfg["height"], cfg["output_pixel_format"])
    worst = 0.0
    by_frame: dict = {}
    for idx, got in outputs:
        got = torch.as_tensor(got).reshape(-1)
        if got.dtype != torch.uint8 or got.numel() != size:
            worst = 1.0
        else:
            by_frame.setdefault(idx, []).append(got)
    for idx, gots in by_frame.items():
        coeff = codec.coefficients(dep.planes(frames[idx].to(device)),
                                   dep.geo, dep.quant)
        best = [torch.full((size,), 1.0, device=device) for _ in gots]
        for out, cost in _candidates(dep, coeff):
            for b, g in zip(best, gots):
                hit = out == g.to(device)
                torch.minimum(b, torch.where(hit, cost, b), out=b)
        worst = max([worst] + [float(b.max()) for b in best])
    return worst
