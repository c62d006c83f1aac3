"""A randomized soak of the port on the CPU, the counterpart of
``scripts/soak.py``: seeded random geometries (odd sizes included),
qualities, restart intervals, samplings, scan orders and input pixel
formats go through the port's torch backend (its kernels' plain
versions), held against the JAX package's golden coder; then truncated
and bit-flipped streams go through the port's decoder, which must
decode them or raise ``JpegParseError`` and nothing else.

In tier-1 a fixed set of cases runs (:data:`CASES` from each of three
seeds). Longer soaks:

    python tests/test_torch_soak.py [seconds] [seed]
"""
import os
import sys
import time

import numpy as np
import pytest

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
import conftest  # noqa: E402,F401  (JAX on the CPU)

import gpujpeg_tpu as ref  # noqa: E402
import gpujpeg_tpu_torch as port  # noqa: E402
import gpujpeg_tpu_torch.models.decoder as dmod  # noqa: E402
from gpujpeg_tpu_torch.types import image_calculate_size  # noqa: E402

#: cases of each seed in the tier-1 run
CASES = 6
#: (pixel format, colour space) of the inputs
FORMATS = [("PF_444_U8_P012", "RGB"), ("PF_444_U8_P012A", "RGB"),
           ("PF_420_U8_P0P1P2", "YCBCR_BT601_256LVLS"),
           ("PF_422_U8_P1020", "YCBCR_BT601_256LVLS"),
           ("U8", "YCBCR_BT601_256LVLS")]
#: a decode of the port's stream may differ from the golden decode of it
#: by this much (the JAX soak's bar: float32 against float64 ties)
MAX_PIXEL_DIFF, MAX_DIFF_SHARE = 4, 1e-3


def _case(rng):
    pf, cs = FORMATS[int(rng.integers(len(FORMATS)))]
    h = int(rng.integers(1, 96))
    w = int(rng.integers(1, 160))
    if pf == "PF_422_U8_P1020":
        w += w % 2
    return dict(h=h, w=w, pf=pf, cs=cs,
                q=int(rng.choice([10, 50, 75, 80, 85, 92, 97, 100])),
                ri=int(rng.choice([0, 1, 2, 4, 8, 16, 32])),
                interleaved=bool(rng.integers(0, 2)),
                sub=int(rng.choice([444, 422, 420])),
                period=(3 + int(rng.integers(40)), 3 + int(rng.integers(40))),
                noise=int(rng.integers(1, 30)))


def _raw(c, rng):
    n = image_calculate_size(c["w"], c["h"], getattr(port.PixelFormat,
                                                     c["pf"]))
    x = np.arange(n)
    base = 128 + 80 * np.sin(x / c["period"][0]) * np.cos(
        (x // max(c["w"], 1)) / c["period"][1])
    return np.clip(base + rng.normal(0, c["noise"], n), 0,
                   255).astype(np.uint8)


def _setup(mod, c):
    params = mod.Parameters(quality=c["q"], restart_interval=c["ri"],
                            interleaved=c["interleaved"])
    if c["sub"] != 444:
        params = params.with_chroma_subsampling(c["sub"])
    image = mod.ImageParameters(
        width=c["w"], height=c["h"], color_space=getattr(mod.ColorSpace,
                                                         c["cs"]),
        pixel_format=getattr(mod.PixelFormat, c["pf"]))
    return params, image


def _decoder(mod, **kw):
    """A decoder to interleaved RGB, which every stream can be packed to
    (the deduced output of an odd-width 4:2:2 stream, UYVY, cannot)."""
    dec = mod.Decoder(**kw)
    dec.set_output_format(mod.ColorSpace.RGB, mod.PixelFormat.PF_444_U8_P012)
    return dec


def run_case(c, rng) -> list[str]:
    """One soak case; returns its failures (empty when it passed)."""
    tag = (f"{c['w']}x{c['h']} {c['pf']} q{c['q']} ri{c['ri']} "
           f"il={int(c['interleaved'])} {c['sub']}")
    raw = _raw(c, rng)
    data = port.Encoder(device="cpu").encode(raw, *_setup(port, c))
    gold = ref.Encoder(backend="golden").encode(raw, *_setup(ref, c))
    fails = []
    if data != gold and abs(len(data) - len(gold)) > max(64,
                                                         len(gold) // 100):
        fails.append(f"stream length {tag}: {len(data)} vs {len(gold)}")
    got, oi = _decoder(port, device="cpu").decode(data)
    want, ref_oi = _decoder(ref, backend="golden").decode(data)
    if (oi.width, oi.height, int(oi.pixel_format)) != (
            ref_oi.width, ref_oi.height, int(ref_oi.pixel_format)):
        fails.append(f"output parameters {tag}")
    elif got.size != np.asarray(want).size:
        fails.append(f"output size {tag}: {got.size}")
    else:
        d = np.abs(got.astype(int) - np.asarray(want).astype(int))
        if d.max() > MAX_PIXEL_DIFF or (d > 0).mean() > MAX_DIFF_SHARE:
            fails.append(f"pixels {tag}: max {d.max()} share "
                         f"{(d > 0).mean():.2e}")
    sos = data.find(b"\xff\xda")
    bads = [("truncated", data[:int(rng.integers(2, max(3, len(data))))])]
    for what, lo, hi in (("flipped header", 2, sos),
                         ("flipped scan", sos + 2, len(data))):
        flip = bytearray(data)
        for _ in range(int(rng.integers(1, 8))):
            flip[int(rng.integers(lo, hi))] ^= 0xFF
        bads.append((what, bytes(flip)))
    for what, bad in bads:
        try:
            info = port.read_image(bad)
            # a flipped size can ask for a frame far larger than the
            # stream, which the plain versions take minutes to decode on
            # the CPU: such streams are parsed only
            if info.width * info.height <= 4 * max(c["w"] * c["h"], 64):
                _decoder(port, device="cpu").decode(bad)
        except port.JpegParseError:
            pass
        except Exception as e:  # the finding the soak is for
            fails.append(f"{what} stream {tag}: {type(e).__name__}: {e}")
    return fails


def soak(seed: int, cases: int | None = None,
         seconds: float | None = None) -> tuple[int, list[str]]:
    """Run ``cases`` cases, or as many as fit in ``seconds``, from
    ``seed`` with every stream on the device route; (cases, failures)."""
    rng = np.random.default_rng(seed)
    t_end = time.time() + (seconds or 0)
    old = dmod.CPU_SEGMENT_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = 0
    n, fails = 0, []
    try:
        while (n < cases) if cases is not None else (time.time() < t_end):
            fails += run_case(_case(rng), rng)
            n += 1
    finally:
        dmod.CPU_SEGMENT_THRESHOLD = old
    return n, fails


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soak_fixed_cases(seed):
    n, fails = soak(seed=seed, cases=CASES)
    assert n == CASES
    assert not fails, "\n".join(fails)


if __name__ == "__main__":
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 600
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    n, fails = soak(seed, seconds=seconds)
    print("\n".join(fails))
    print(f"soak: {n} cases, {len(fails)} failures", flush=True)
    sys.exit(1 if fails else 0)
