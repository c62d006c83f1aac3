"""The least time the card needs for a frame's work: the yardstick of the
``*.kernels_roofline_pct`` metrics, frozen here.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
device memory at 3.35 TB/s and float32 outside the tensor cores at 67
TFLOP/s. An 8x8 (I)DCT in separable form counts 2,176 float32
operations (16 eight-point transforms of 8 dot products of 8 terms, an
FMA two, plus 64 (de)quantisation multiplies and 64 level-shift adds);
a 3x3 colour transform 384 a block of one component (3 FMAs a value).
Integer and bit operations (entropy coding, the integer colour
transforms of planar formats) have no peak in the data sheet's table and
are not counted. The same arithmetic as ``chip_smoke.py``'s bounds.
"""
from __future__ import annotations

from .reference.geometry import Geometry, raw_size

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
DCT_BLOCK_FLOPS = 2 * 16 * 8 * 8 + 64 + 64
COLOUR_BLOCK_FLOPS = 2 * 3 * 64


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(seconds, what bounds it) of work that moves ``bytes_moved`` (each
    input read once, each output written once) and does ``flops``."""
    t_b = bytes_moved / PEAK_BYTES_S
    t_o = flops / PEAK_F32_S
    return (t_o, "operations") if t_o > t_b else (t_b, "bytes")


def frame_bound(cfg: dict, geo: Geometry, stream_bytes: float,
                direction: str) -> tuple[float, str]:
    """The bound of one frame's encode (the raw frame read, the stream
    written) or decode (the stream read, the output frame written): the
    DCT of every block, and a 3x3 colour transform a block where the
    frame's side of the colour pair is RGB (the transform from or to
    YCbCr that the DCT and IDCT kernels fold in on that route)."""
    if direction == "encode":
        side = cfg["color_space"]
        frame = raw_size(cfg["width"], cfg["height"], cfg["pixel_format"])
    else:
        side = cfg["output_color_space"]
        frame = raw_size(cfg["width"], cfg["height"],
                         cfg["output_pixel_format"])
    per_block = DCT_BLOCK_FLOPS + (COLOUR_BLOCK_FLOPS if side == "RGB"
                                   and cfg["color_space_internal"] != "RGB"
                                   else 0)
    return bound(frame + stream_bytes, geo.n_blocks * per_block)
