"""A randomized soak of the port's kernels, the counterpart of
``scripts/soak.py``: seeded random geometries (odd sizes included, up to
the JAX soak's 176x312), qualities, restart intervals, samplings, scan
orders and input pixel formats go through ``Encoder`` and ``Decoder``
on the device, then truncated and bit-flipped streams go through the
decoder.

    python -m gpujpeg_tpu_torch.tools.soak [--device cuda|cpu]
        [--seconds S | --cases N] [--seed S] [--index I] [--threads N]
        [--fresh-build]

Case ``i`` of seed ``s`` is drawn from its own generator,
``np.random.default_rng([s, i])`` (:func:`case`; the input and the
corrupt streams from ``[s, i, 1]`` and ``[s, i, 2]``), so a failure is
rebuilt alone with ``--seed s --index i``. Every stream takes the device
route (``CPU_SEGMENT_THRESHOLD = CPU_BLOCK_THRESHOLD = 0``). On the card
each case is held to two references:

1. the port's CPU route (the kernels' plain versions) on the same input:
   the stream equal, or equal in every segment without a .5 DCT tie
   (``checks.card_vs_cpu``); the card's decode of it equal to the CPU
   route's under the IDCT rule (``checks.decode_pair``: coefficients
   exact, bytes within 2);
2. the port's golden coder, the reference's host code: the stream's
   length within the JAX soak's bound of the golden stream's
   (:func:`length_ok`), and the card's decode within
   :data:`MAX_PIXEL_DIFF` of the golden decode of the same stream in all
   but :data:`MAX_DIFF_SHARE` of its bytes.

The three corrupt streams of a case (truncated, a flipped header, a
flipped scan): where the stream's frame is at most :data:`FRAME_GROWTH`
times the original's, the card's decode equals the CPU route's under the
IDCT rule, or both raise ``JpegParseError``; a larger frame must decode
or raise ``JpegParseError``, and a ``torch.OutOfMemoryError`` there is
counted as ``oom``, not as a failure. Any other exception is a failure,
printed as one line that rebuilds the case: ``SOAK FAIL seed=s index=i
<case>: <what>``. A CUDA error (a launch failure, an illegal address, a
sticky error) stops the soak at the case that raised it, since nothing
may run on in a poisoned context: every case ends with
``torch.cuda.synchronize()``.

``--device cpu`` runs the plain versions against the golden coder alone,
and only parses corrupt headers that ask for a frame over
``FRAME_GROWTH`` times the original (the plain D1 takes minutes on
them). ``--threads N`` runs N threads, each with its own coders, on
disjoint case indices; ``--fresh-build`` first points
``GPUJPEG_TPU_TORCH_BUILD_DIR`` at a new empty directory, so all N
threads make their first launch into an unbuilt kernel library. The last
line of standard output is ``{"cases": n, "failures": k, "oom": m,
"cases_per_s": r, "card": ...}``; the exit code is 1 where a case
failed.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch

#: (pixel format, colour space) of the inputs, each with its weight:
#: half the cases take the JAX soak's only input, interleaved RGB, the
#: other half the test's four other formats
FORMATS = [("PF_444_U8_P012", "RGB"), ("PF_444_U8_P012A", "RGB"),
           ("PF_420_U8_P0P1P2", "YCBCR_BT601_256LVLS"),
           ("PF_422_U8_P1020", "YCBCR_BT601_256LVLS"),
           ("U8", "YCBCR_BT601_256LVLS")]
FORMAT_WEIGHTS = (4 / 8, 1 / 8, 1 / 8, 1 / 8, 1 / 8)
QUALITIES = (10, 50, 75, 80, 85, 92, 97, 100)
INTERVALS = (0, 1, 2, 4, 8, 16, 32)
#: the largest frame, the JAX soak's (``scripts/soak.py``: 22 and 39
#: blocks of 8). Half the cases draw a size of whole blocks as it does
#: (the only sizes the E1 and D2 routes take: no MCU padding), the other
#: half any size, odd ones included
MAX_HEIGHT, MAX_WIDTH = 176, 312
#: a decode of the port's stream may differ from the golden decode of it
#: by this much (the JAX soak's bar: float32 against float64 ties)
MAX_PIXEL_DIFF, MAX_DIFF_SHARE = 4, 1e-3
#: a corrupt stream whose frame is at most this many times the
#: original's (or 64 pixels) is decoded on both routes and compared
FRAME_GROWTH = 4


def case(seed: int, index: int) -> dict:
    """Case ``index`` of ``seed``, from its own generator."""
    rng = np.random.default_rng([seed, index])
    pf, cs = FORMATS[int(rng.choice(len(FORMATS), p=FORMAT_WEIGHTS))]
    if rng.integers(0, 2):
        h = 8 * int(rng.integers(1, MAX_HEIGHT // 8 + 1))
        w = 8 * int(rng.integers(1, MAX_WIDTH // 8 + 1))
    else:
        h = int(rng.integers(1, MAX_HEIGHT + 1))
        w = int(rng.integers(1, MAX_WIDTH + 1))
    if pf == "PF_422_U8_P1020":
        w += w % 2
    return dict(seed=seed, index=index, h=h, w=w, pf=pf, cs=cs,
                q=int(rng.choice(QUALITIES)), ri=int(rng.choice(INTERVALS)),
                interleaved=bool(rng.integers(0, 2)),
                sub=int(rng.choice([444, 422, 420])),
                period=(3 + int(rng.integers(40)), 3 + int(rng.integers(40))),
                noise=int(rng.integers(1, 30)))


def describe(c: dict) -> str:
    return (f"{c['w']}x{c['h']} {c['pf']} q{c['q']} ri{c['ri']} "
            f"il={int(c['interleaved'])} {c['sub']}")


def raw_input(c: dict) -> np.ndarray:
    """The case's raw frame: smooth waves plus noise, in its pixel
    format's bytes."""
    from .. import PixelFormat
    from ..types import image_calculate_size
    rng = np.random.default_rng([c["seed"], c["index"], 1])
    n = image_calculate_size(c["w"], c["h"], getattr(PixelFormat, c["pf"]))
    x = np.arange(n)
    base = 128 + 80 * np.sin(x / c["period"][0]) * np.cos(
        (x // max(c["w"], 1)) / c["period"][1])
    return np.clip(base + rng.normal(0, c["noise"], n), 0,
                   255).astype(np.uint8)


def setup(c: dict, mod=None):
    """(Parameters, ImageParameters) of the case, from ``mod`` (this
    package, or another with the same API)."""
    if mod is None:
        import gpujpeg_tpu_torch as mod
    params = mod.Parameters(quality=c["q"], restart_interval=c["ri"],
                            interleaved=c["interleaved"])
    if c["sub"] != 444:
        params = params.with_chroma_subsampling(c["sub"])
    image = mod.ImageParameters(
        width=c["w"], height=c["h"], color_space=getattr(mod.ColorSpace,
                                                         c["cs"]),
        pixel_format=getattr(mod.PixelFormat, c["pf"]))
    return params, image


def decoder(mod=None, **kw):
    """A decoder to interleaved RGB, which every stream can be packed to
    (the deduced output of an odd-width 4:2:2 stream, UYVY, cannot)."""
    if mod is None:
        import gpujpeg_tpu_torch as mod
    dec = mod.Decoder(**kw)
    dec.set_output_format(mod.ColorSpace.RGB, mod.PixelFormat.PF_444_U8_P012)
    return dec


def corrupt_streams(data: bytes, c: dict) -> list[tuple[str, bytes]]:
    """The case's three bad streams: (what, bytes) of a truncation, 1-7
    flipped bytes in the headers and 1-7 in the scan."""
    rng = np.random.default_rng([c["seed"], c["index"], 2])
    sos = data.find(b"\xff\xda")
    bads = [("truncated", data[:int(rng.integers(2, max(3, len(data))))])]
    for what, lo, hi in (("flipped header", 2, sos),
                         ("flipped scan", sos + 2, len(data))):
        flip = bytearray(data)
        for _ in range(int(rng.integers(1, 8))):
            flip[int(rng.integers(lo, hi))] ^= 0xFF
        bads.append((what, bytes(flip)))
    return bads


def length_ok(data: bytes, gold: bytes) -> bool:
    """The JAX soak's bound: a stream other than the golden one is within
    1% (or 64 bytes) of its length."""
    return data == gold or abs(len(data) - len(gold)) <= max(64,
                                                             len(gold) // 100)


def small_frame(info, c: dict) -> bool:
    """True when a parsed stream's frame is at most :data:`FRAME_GROWTH`
    times the case's (or 64 pixels)."""
    return info.width * info.height <= FRAME_GROWTH * max(c["w"] * c["h"],
                                                          64)


def pixel_gap(got: np.ndarray, want: np.ndarray) -> str | None:
    """None when ``got`` is within the golden bar of ``want``, else what
    differs."""
    got, want = np.asarray(got), np.asarray(want)
    if got.size != want.size:
        return f"output size {got.size}, golden {want.size}"
    d = np.abs(got.astype(np.int16).reshape(-1) - want.reshape(-1))
    if d.size and (d.max() > MAX_PIXEL_DIFF
                   or (d > 0).mean() > MAX_DIFF_SHARE):
        return f"pixels: max {d.max()} share {(d > 0).mean():.2e}"
    return None


class CudaError(Exception):
    """A CUDA error in a case: the context may be poisoned, so the soak
    stops."""


def cuda_error(e: BaseException) -> bool:
    """True for an error of the CUDA runtime or a kernel launch (not an
    out-of-memory error)."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or (
        isinstance(e, RuntimeError) and "CUDA" in str(e))


class Coders:
    """One thread's coders: the device's, the CPU route's (on a card) and
    the golden ones."""

    def __init__(self, device: torch.device):
        from .. import Encoder
        self.device = device
        self.enc = Encoder(backend="torch", device=device)
        self.dec = decoder(backend="torch", device=device)
        on_card = device.type != "cpu"
        self.cpu_enc = Encoder(backend="torch", device="cpu") \
            if on_card else None
        self.cpu_dec = decoder(backend="torch", device="cpu") \
            if on_card else None
        self.gold_enc = Encoder(backend="golden")
        self.gold_dec = decoder(backend="golden")


def _outcome(fn):
    """(kind, value) of ``fn()``: ``ok`` and its result, or ``parse`` or
    ``oom`` and the exception; other exceptions propagate."""
    from ..stream.reader import JpegParseError
    try:
        return "ok", fn()
    except JpegParseError as e:
        return "parse", e
    except torch.OutOfMemoryError as e:
        return "oom", e


def _corrupt(co: Coders, c: dict, bad: bytes) -> tuple[str | None, str]:
    """(what fails or None, the outcome) of one corrupt stream. The
    outcome is ``parsed only``, ``oom``, or ``small`` / ``large`` (the
    frame against :data:`FRAME_GROWTH`) and the device decode's ``ok`` or
    ``parse``."""
    from . import checks
    from ..stream.reader import JpegParseError, read_image
    try:
        small = small_frame(read_image(bad), c)
    except JpegParseError:
        small = True
    if not small and co.cpu_dec is None:
        return None, "parsed only"
    kind, val = _outcome(lambda: co.dec.decode(bad))
    if kind == "oom":
        torch.cuda.empty_cache()
        if small:
            return f"out of memory on a small frame: {val}", kind
        return None, kind
    outcome = f"{'small' if small else 'large'} {kind}"
    if not small or co.cpu_dec is None:
        return None, outcome
    if kind == "ok":
        cpu = _outcome(lambda: checks.decode_pair(bad, val[1], val[0],
                                                  co.device))
    else:
        cpu = _outcome(lambda: co.cpu_dec.decode(bad))
    if kind != cpu[0]:
        return (f"the {co.device} decode gave {kind}, the CPU route's "
                f"{cpu[0]} ({val if kind != 'ok' else cpu[1]})"), outcome
    return None, outcome


def run_case(co: Coders, c: dict) -> tuple[list[str], Counter]:
    """One case on ``co``: (its failures, the outcomes of its corrupt
    streams, and for a case at interval 0 ``interval 0`` and the lanes
    its card decode launched, ``interval 0 lanes``). Raises
    :class:`CudaError` on a CUDA error."""
    from . import checks
    from ..ops.decode import huffman_lanes
    fails, outcomes = [], Counter()
    raw = raw_input(c)
    params, image = setup(c)

    def step(what, fn):
        try:
            return fn()
        except Exception as e:  # each finding is a line; CUDA errors stop
            if cuda_error(e):
                raise CudaError(f"{what}: {type(e).__name__}: {e}") from e
            fails.append(f"{what}: {type(e).__name__}: {e}")
            return None

    def encode():
        data = co.enc.encode(raw, params, image)
        if co.cpu_enc is not None:
            ref = co.cpu_enc.encode(raw, params, image)
            if data != ref:
                checks.card_vs_cpu(raw, params, image, data, ref, co.device)
        gold = co.gold_enc.encode(raw, params, image)
        if not length_ok(data, gold):
            fails.append(f"stream length {len(data)}, golden {len(gold)}")
        return data

    def decode():
        before = huffman_lanes.lanes
        got, oi = co.dec.decode(data)
        if c["ri"] == 0:
            outcomes["interval 0"] += 1
            outcomes["interval 0 lanes"] += huffman_lanes.lanes - before
        want, _ = co.gold_dec.decode(data)
        gap = pixel_gap(got, want)
        if gap:
            fails.append(f"decode vs golden: {gap}")
        if co.cpu_dec is not None:
            checks.decode_pair(data, oi, got, co.device)

    data = step("encode", encode)
    if data is not None:
        step("decode", decode)
        for what, bad in corrupt_streams(data, c):
            got = step(f"{what} stream", lambda: _corrupt(co, c, bad))
            if got is not None:
                if got[0]:
                    fails.append(f"{what} stream: {got[0]}")
                outcomes[got[1]] += 1
    if co.device.type == "cuda":
        step("synchronize", lambda: torch.cuda.synchronize(co.device))
    return fails, outcomes


def fail_line(c: dict, what: str) -> str:
    return f"SOAK FAIL seed={c['seed']} index={c['index']} {describe(c)}: {what}"


def soak(seed: int, device="cuda", cases: int | None = None,
         seconds: float | None = None, threads: int = 1,
         index: int | None = None) -> dict:
    """Run the cases of ``seed`` on ``device`` in ``threads`` threads:
    ``index`` alone, or indices 0 .. ``cases`` - 1, or as many as fit in
    ``seconds``; print each failure. Returns ``{"cases",
    "failures", "oom", "cases_per_s", "lines", "outcomes"}``, ``lines``
    the failure lines (a CUDA error stops every thread and is the last
    line), ``outcomes`` the corrupt streams' (:func:`_corrupt`)."""
    import gpujpeg_tpu_torch.models.decoder as dmod
    device = torch.device(device)
    if index is not None:
        todo, threads = iter([index]), 1
    elif cases is not None:
        todo = iter(range(cases))
    else:
        todo = iter(range(1 << 62))
    t_end = time.perf_counter() + (seconds or 0)
    lock, stop = threading.Lock(), threading.Event()
    start = threading.Barrier(threads)
    res = {"cases": 0, "failures": 0, "oom": 0, "lines": [],
           "outcomes": Counter()}

    def next_case():
        with lock:
            if stop.is_set() or (cases is None and index is None
                                 and time.perf_counter() >= t_end):
                return None
            return next(todo, None)

    def report(lines, cases=0, outcomes=None):
        with lock:
            res["cases"] += cases
            res["outcomes"] += outcomes or Counter()
            res["oom"] = res["outcomes"]["oom"]
            res["failures"] += bool(lines)
            res["lines"] += lines
            for line in lines:
                print(line, flush=True)

    def worker():
        start.wait()
        try:
            co = Coders(device)
        except Exception as e:  # reported as a failure of the run
            stop.set()
            report([f"SOAK FAIL seed={seed} index=-1 coders: {e!r}"])
            return
        while (i := next_case()) is not None:
            c = case(seed, i)
            try:
                lines, outcomes = run_case(co, c)
            except CudaError as e:
                stop.set()
                lines, outcomes = [f"CUDA error, soak stopped: {e}"], Counter()
            report([fail_line(c, line) for line in lines], 1, outcomes)

    old = dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = dmod.CPU_BLOCK_THRESHOLD = 0
    t0 = time.perf_counter()
    try:
        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        dmod.CPU_SEGMENT_THRESHOLD, dmod.CPU_BLOCK_THRESHOLD = old
    res["cases_per_s"] = res["cases"] / (time.perf_counter() - t0)
    return res


def fresh_build_dir() -> str:
    """Point the kernel build dir at a new empty directory in the
    per-user cache, before this process has loaded the library."""
    from .. import _build
    from ..runtime import user_cache_dir
    if _build._KERNELS is not None:
        raise RuntimeError("--fresh-build: the kernel library is already "
                           "loaded in this process")
    path = tempfile.mkdtemp(prefix="fresh-", dir=user_cache_dir())
    os.environ["GPUJPEG_TPU_TORCH_BUILD_DIR"] = path
    return path


def main(argv: list | None = None) -> int:
    from . import card_line
    from . import device as tool_device
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    g = p.add_mutually_exclusive_group()
    g.add_argument("--seconds", type=float, default=None)
    g.add_argument("--cases", type=int, default=None)
    g.add_argument("--index", type=int, default=None,
                   help="run case INDEX of the seed alone")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--fresh-build", action="store_true",
                   help="build the kernels into a new empty directory "
                        "at the threads' first launch")
    args = p.parse_args(argv)
    if args.threads < 1:
        p.error("--threads must be at least 1")
    dev = tool_device(args.device)
    seconds = args.seconds
    if seconds is None and args.cases is None and args.index is None:
        seconds = 600.0
    old_dir = os.environ.get("GPUJPEG_TPU_TORCH_BUILD_DIR")
    fresh = fresh_build_dir() if args.fresh_build else None
    try:
        res = soak(args.seed, dev, args.cases, seconds, args.threads,
                   args.index)
        if fresh is not None:
            libs = sorted(os.listdir(fresh))
            print(f"fresh build: {args.threads} threads' first launches "
                  f"into {fresh} left {libs}", flush=True)
            if dev.type == "cuda" and len(libs) != 1:
                res["failures"] += 1
                print(f"SOAK FAIL seed={args.seed} index=-1 fresh build: "
                      f"the build dir holds {libs}", flush=True)
    finally:
        if fresh is not None:
            shutil.rmtree(fresh, ignore_errors=True)
            if old_dir is None:
                del os.environ["GPUJPEG_TPU_TORCH_BUILD_DIR"]
            else:
                os.environ["GPUJPEG_TPU_TORCH_BUILD_DIR"] = old_dir
    print(f"soak: seed {args.seed}, {res['cases']} cases on {dev}, "
          f"{res['failures']} failing, {res['oom']} oom; corrupt streams "
          f"{dict(sorted(res['outcomes'].items()))}", flush=True)
    print(json.dumps({"cases": res["cases"], "failures": res["failures"],
                      "oom": res["oom"], "cases_per_s": res["cases_per_s"],
                      "card": card_line(dev)}), flush=True)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
