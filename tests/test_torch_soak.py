"""A randomized soak of the port on the CPU, the counterpart of
``scripts/soak.py``: the cases of ``gpujpeg_tpu_torch.tools.soak``
(seeded random geometries up to the JAX soak's 176x312, odd sizes
included, qualities, restart intervals, samplings, scan orders and input
pixel formats) go through the port's torch backend (its kernels' plain
versions), held against the JAX package's golden coder; then truncated
and bit-flipped streams go through the port's decoder, which must decode
them or raise ``JpegParseError`` and nothing else. The same cases run on
the card with ``python -m gpujpeg_tpu_torch.tools.soak``.

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
from gpujpeg_tpu_torch.tools.soak import (  # noqa: E402
    MAX_DIFF_SHARE, MAX_PIXEL_DIFF, corrupt_streams, decoder, describe,
    length_ok, raw_input, setup, small_frame)
from gpujpeg_tpu_torch.tools import soak as soak_tool  # noqa: E402

#: cases of each seed in the tier-1 run
CASES = 6


def run_case(c) -> list[str]:
    """One soak case; returns its failures (empty when it passed)."""
    tag = describe(c)
    raw = raw_input(c)
    data = port.Encoder(device="cpu").encode(raw, *setup(c, port))
    gold = ref.Encoder(backend="golden").encode(raw, *setup(c, ref))
    fails = []
    if not length_ok(data, gold):
        fails.append(f"stream length {tag}: {len(data)} vs {len(gold)}")
    got, oi = decoder(port, device="cpu").decode(data)
    want, ref_oi = decoder(ref, backend="golden").decode(data)
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
    for what, bad in corrupt_streams(data, c):
        try:
            # a flipped size can ask for a frame far larger than the
            # stream, which the plain versions take minutes to decode on
            # the CPU: such streams are parsed only
            if small_frame(port.read_image(bad), c):
                decoder(port, device="cpu").decode(bad)
        except port.JpegParseError:
            pass
        except Exception as e:  # the finding the soak is for
            fails.append(f"{what} stream {tag}: {type(e).__name__}: {e}")
    return fails


def soak(seed: int, cases: int | None = None,
         seconds: float | None = None) -> tuple[int, list[str]]:
    """Run ``cases`` cases, or as many as fit in ``seconds``, from
    ``seed`` with every stream on the device route; (cases, failures)."""
    t_end = time.time() + (seconds or 0)
    old = dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = dmod.CPU_BLOCK_THRESHOLD = 0
    n, fails = 0, []
    try:
        while (n < cases) if cases is not None else (time.time() < t_end):
            fails += run_case(soak_tool.case(seed, n))
            n += 1
    finally:
        dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD = old
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
