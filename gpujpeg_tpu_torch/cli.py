"""``gpujpegtool``-compatible command line interface.

Mirrors the reference CLI's option surface and behavior
(reference: src/main.c:220-817): encode/decode auto-detected from file
extensions, multi-image batches as input/output pairs, iteration
benchmarking with per-phase stats, JPEG info mode, raw-image conversion
and component-range modes. The port's counterpart of the JAX package's
``gpujpeg_tpu/cli.py``, with the same options and flows: ``-b`` picks
the ``torch`` backend (default) or the host ``golden`` coder, ``-L``
lists the CUDA devices and ``-D N`` runs on ``cuda:N``; ``-D cpu`` runs
the kernels' plain torch versions on the CPU, and without it the torch
backend needs a CUDA device, as ``Encoder(device="cuda")`` does. The
OpenGL path has no counterpart (CUDA tensors through the library API
are the zero-copy device interface) and reports so.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import time

import numpy as np
import torch

from . import __version__
from .models.decoder import Decoder
from .models.encoder import Encoder
from .params import ImageParameters, Parameters, suggest_restart_interval
from .stream import reader as stream_reader
from .types import (
    ColorSpace,
    PIXEL_FORMAT_DESC,
    PixelFormat,
    color_space_name,
    pixel_format_by_name,
    subsampling_name,
)
from .utils import image_io
from .utils.image_io import FileFormat

_CS_BY_NAME = {
    "rgb": ColorSpace.RGB,
    "yuv": ColorSpace.YUV,
    "ycbcr": ColorSpace.YCBCR_BT601_256LVLS,
    "ycbcr-jpeg": ColorSpace.YCBCR_BT601_256LVLS,
    "ycbcr-bt601": ColorSpace.YCBCR_BT601,
    "ycbcr-bt709": ColorSpace.YCBCR_BT709,
}


def _parse_size(s: str) -> tuple[int, int]:
    w, _, h = s.lower().partition("x")
    return int(w), int(h)


def _device(arg: str) -> torch.device:
    """``-D``'s value -> the torch device: ``cpu``, or ``cuda:N``."""
    if arg == "cpu":
        return torch.device("cpu")
    try:
        return torch.device("cuda", int(arg))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"a CUDA device index or cpu, got {arg!r}") from None


_FRAME_PATTERN_RE = re.compile(r"%0?\d*d")


def _is_frame_pattern(path: str) -> bool:
    """True only for printf-style integer frame patterns (``%d``/``%03d``),
    not for any filename that merely contains a '%'."""
    return bool(_FRAME_PATTERN_RE.search(path))


def _collect_frames(src: str) -> tuple[list[str], str | None]:
    """Existing frame files for a %d pattern, 0- or 1-based, contiguous.

    Returns (paths, warning). Stops at the first gap; if a file exists
    just past the gap the warning says where the sequence was truncated
    so a missing middle frame can't silently drop the tail.
    """
    start = 0 if os.path.exists(src % 0) else 1
    paths = []
    fi = start
    while os.path.exists(src % fi):
        paths.append(src % fi)
        fi += 1
    warn = None
    if paths and any(os.path.exists(src % (fi + k)) for k in range(1, 4)):
        warn = (f"frame sequence has a gap at {src % fi}; "
                f"stopping after {len(paths)} frames")
    return paths, warn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpujpegtool-torch",
        description="CUDA-accelerated baseline JPEG encoder/decoder "
                    "(gpujpeg_tpu_torch %s)" % __version__,
    )
    p.add_argument("-e", "--encode", action="store_true")
    p.add_argument("-d", "--decode", action="store_true")
    p.add_argument("-C", "--convert", action="store_true",
                   help="convert raw image (color space / pixel format)")
    p.add_argument("-R", "--component-range", action="store_true",
                   help="show sample range for each component")
    p.add_argument("-I", "--info", metavar="FILE",
                   help="print JPEG or raw file info")
    p.add_argument("-L", "--device-list", action="store_true")
    p.add_argument("-D", "--device", type=_device, default="0",
                   metavar="N|cpu",
                   help="CUDA device index, or cpu for the plain torch "
                        "versions (default 0)")
    p.add_argument("-s", "--size", metavar="WxH")
    p.add_argument("-f", "--pixel-format", metavar="FMT",
                   help="e.g. u8, 444-u8-p012, 422-u8-p1020, 420-u8-p0p1p2")
    p.add_argument("-c", "--colorspace", choices=sorted(_CS_BY_NAME))
    p.add_argument("-q", "--quality", type=int, default=None,
                   help="JPEG quality 0-100 (default 75)")
    p.add_argument("-r", "--restart", type=int, default=None,
                   help="restart interval (default: auto)")
    p.add_argument("-S", "--subsampled", nargs="?", const=420, type=int,
                   choices=(444, 422, 420))
    p.add_argument("-i", "--interleaved", action="store_true")
    p.add_argument("-g", "--segment-info", action="store_true")
    p.add_argument("-n", "--iterate", type=int, default=1)
    p.add_argument("-o", "--use-opengl", action="store_true",
                   help="(no counterpart; CUDA tensors through the "
                        "library API are the zero-copy interface)")
    p.add_argument("-N", "--native", action="store_true",
                   help="keep input color space in the JPEG "
                        "(Adobe RGB / SPIFF BT.709)")
    p.add_argument("-a", "--alpha", action="store_true",
                   help="encode alpha channel (otherwise stripped)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-b", "--backend", choices=("torch", "golden"),
                   default="torch", help="compute backend (golden = host "
                   "reference path)")
    p.add_argument("files", nargs="*", metavar="IN OUT")
    return p


def _print_image_params(img: ImageParameters, sub: str | None = None) -> None:
    if img.width:
        print(f"width: {img.width}")
    if img.height:
        print(f"height: {img.height}")
    if img.pixel_format != PixelFormat.NONE:
        print(f"component count: {img.comp_count}")
    if img.color_space != ColorSpace.NONE:
        print(f"color space: {color_space_name(img.color_space)}")
    if img.pixel_format != PixelFormat.NONE:
        name = PIXEL_FORMAT_DESC[PixelFormat(img.pixel_format)].name
        extra = f" ({sub})" if sub else ""
        print(f"internal representation: {name}{extra}")


def cmd_info(filename: str, verbose: int) -> int:
    """(reference: print_image_info, src/main.c:113-160)"""
    fmt = image_io.image_get_file_format(filename)
    if fmt == FileFormat.JPEG:
        with open(filename, "rb") as f:
            data = f.read()
        info = stream_reader.get_image_info(data)
        img = ImageParameters(width=info.width, height=info.height,
                              color_space=info.color_space,
                              pixel_format=info.deduce_pixel_format())
        sub = subsampling_name(info.sampling, info.comp_count)
        _print_image_params(img, sub)
        print(f"interleaved: {'yes' if info.interleaved else 'no'}")
        if info.segment_count:
            print(f"segment count: {info.segment_count} "
                  f"(DRI = {info.restart_interval})")
        return 0
    img = image_io.image_get_properties(filename, file_exists=True)
    _print_image_params(img)
    return 0


def _adjust_params(args, params: Parameters, image: ImageParameters,
                   raw_file: str, encode: bool
                   ) -> tuple[Parameters, ImageParameters]:
    """Fill unset image/codec parameters from the raw file's probed
    properties (reference: adjust_params, src/main.c:160-214)."""
    probed = image_io.image_get_properties(raw_file, file_exists=encode)
    width = image.width or probed.width
    height = image.height or probed.height
    cs = image.color_space if image.color_space != ColorSpace.NONE \
        else probed.color_space
    pf = image.pixel_format if image.pixel_format != PixelFormat.NONE \
        else probed.pixel_format
    if cs == ColorSpace.NONE:
        cs = ColorSpace.RGB
    if not args.alpha and pf == PixelFormat.PF_444_U8_P012A:
        pf = PixelFormat.PF_444_U8_P012Z  # same layout, alpha dropped
    image = ImageParameters(width=width, height=height, color_space=cs,
                            pixel_format=pf)

    if encode:
        sub = args.subsampled
        if sub is None:
            desc = PIXEL_FORMAT_DESC.get(PixelFormat(pf))
            sub = {(2, 2): 420, (2, 1): 422}.get(
                (desc.sampling[0].horizontal, desc.sampling[0].vertical), 444) \
                if desc and pf != PixelFormat.NONE else 444
        params = params.with_chroma_subsampling(sub)
        if args.restart is None:
            ri = suggest_restart_interval(
                image, subsampled=(sub != 444),
                interleaved=params.interleaved, pow2=True,
                quality=params.quality)
            params = dataclasses.replace(params, restart_interval=ri)
    if args.native:
        params = dataclasses.replace(params, color_space_internal=cs)
    return params, image


def _print_stats(prefix: str, stats, iteration_ms: float, verbose: int):
    print(f"{prefix} duration: {iteration_ms:.2f} ms")
    if verbose:
        for k, v in stats.asdict().items():
            if not v:
                continue
            if k.startswith("bytes_"):
                print(f"  {k:>20}: {v / 1e6:8.3f} MB")
            else:
                print(f"  {k.replace('duration_', ''):>20}: {v:8.3f} ms")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.device_list:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            print("no CUDA device is available", file=sys.stderr)
            return 1
        for i in range(n):
            print(f"Device #{i}: {torch.cuda.get_device_name(i)} (cuda)")
        return 0
    if args.info is not None:
        return cmd_info(args.info, args.verbose)
    if args.use_opengl:
        print("note: OpenGL interop has no counterpart; pass/receive CUDA "
              "tensors via the library API instead", file=sys.stderr)

    files = args.files
    if len(files) % 2 != 0 or not files:
        print("Please supply source and destination image filename(s)!",
              file=sys.stderr)
        return 2

    params = Parameters(
        quality=args.quality if args.quality is not None else 75,
        restart_interval=args.restart if args.restart is not None else 8,
        interleaved=bool(args.interleaved),
        segment_info=bool(args.segment_info),
        verbose=args.verbose,
        perf_stats=True,
    )
    image = ImageParameters(
        width=0, height=0,
        color_space=_CS_BY_NAME[args.colorspace] if args.colorspace
        else ColorSpace.NONE,
        pixel_format=pixel_format_by_name(args.pixel_format)
        if args.pixel_format else PixelFormat.NONE,
    )
    if args.size:
        w, h = _parse_size(args.size)
        image = dataclasses.replace(image, width=w, height=h)

    encoder = None
    decoder = None
    rc = 0
    for i in range(0, len(files), 2):
        src, dst = files[i], files[i + 1]
        in_fmt = image_io.image_get_file_format(src)
        out_fmt = image_io.image_get_file_format(dst)
        encode = args.encode or (not args.decode and not args.convert
                                 and out_fmt == FileFormat.JPEG)
        decode = args.decode or (not encode and not args.convert
                                 and in_fmt == FileFormat.JPEG)

        if args.component_range:
            data, probed = image_io.load_image(src)
            p, img = _adjust_params(args, params, image, src, True)
            for ci, (lo, hi) in enumerate(image_io.image_range_info(
                    data, img.width, img.height, img.pixel_format)):
                print(f"component #{ci}: {lo}..{hi}")
            continue

        if args.convert:
            p, img = _adjust_params(args, params, image, src, True)
            data, probed = image_io.load_image(src)
            out_img = image_io.image_get_properties(dst, file_exists=False)
            out_img = dataclasses.replace(
                out_img, width=img.width, height=img.height)
            from .ops.preprocess import unpack_raw, pack_raw
            from .ops.colorspace import transform
            chans = unpack_raw(data, img, np)
            chans = transform(chans, img.color_space,
                              out_img.color_space or img.color_space, np)
            image_io.save_image(dst, pack_raw(chans, out_img, np), out_img)
            print(f"converted {src} -> {dst}")
            continue

        if encode:
            p, img = _adjust_params(args, params, image, src, True)
            if img.width <= 0 or img.height <= 0:
                print("Image dimensions must be set to nonzero values!",
                      file=sys.stderr)
                rc = 1
                continue
            if encoder is None:
                encoder = Encoder(backend=args.backend, device=args.device)
            # Y4M video batch: with a %d output pattern, encode every frame
            if in_fmt == FileFormat.Y4M and _is_frame_pattern(dst):
                with open(src, "rb") as f:
                    y4m_info, frames = image_io.y4m_read_frames(f.read())
                if args.verbose:
                    # per-frame stats need per-frame syncs
                    for fi, frame in enumerate(frames):
                        t0 = time.perf_counter()
                        jpeg = encoder.encode(frame, p, img)
                        ms = (time.perf_counter() - t0) * 1e3
                        _print_stats(f"Encode frame {fi}", encoder.stats,
                                     ms, args.verbose)
                        with open(dst % fi, "wb") as f:
                            f.write(jpeg)
                else:
                    t0 = time.perf_counter()
                    jpegs = encoder.encode_batch(frames, p, img)
                    ms = (time.perf_counter() - t0) * 1e3 / max(
                        len(frames), 1)
                    for fi, jpeg in enumerate(jpegs):
                        with open(dst % fi, "wb") as f:
                            f.write(jpeg)
                    print(f"{src}: encoded {len(frames)} frames -> {dst} "
                          f"({ms:.2f} ms/frame)")
                    continue
                print(f"{src}: encoded {len(frames)} frames -> {dst}")
                continue
            data, _ = image_io.load_image(src)
            for it in range(args.iterate):
                t0 = time.perf_counter()
                jpeg = encoder.encode(data, p, img)
                ms = (time.perf_counter() - t0) * 1e3
                _print_stats("Encode", encoder.stats, ms, args.verbose)
            with open(dst, "wb") as f:
                f.write(jpeg)
            if args.verbose:
                print(f"{src} ({img.width}x{img.height}) -> {dst} "
                      f"({len(jpeg)} bytes)")
        elif decode:
            if not _is_frame_pattern(src):
                with open(src, "rb") as f:
                    jpeg = f.read()
            if decoder is None:
                decoder = Decoder(backend=args.backend, device=args.device,
                                  perf_stats=bool(args.verbose))
            out_probe = image_io.image_get_properties(dst, file_exists=False)
            if out_probe.pixel_format != PixelFormat.NONE:
                decoder.set_output_format(
                    out_probe.color_space or ColorSpace.RGB,
                    out_probe.pixel_format)
            if image.color_space != ColorSpace.NONE or \
                    image.pixel_format != PixelFormat.NONE:
                decoder.set_output_format(
                    image.color_space if image.color_space != ColorSpace.NONE
                    else (out_probe.color_space or ColorSpace.RGB),
                    image.pixel_format if image.pixel_format != PixelFormat.NONE
                    else out_probe.pixel_format)
            # frame-sequence batch: with a %d input pattern, decode every
            # existing frame through the pipelined batch path (host parse
            # of frame i+1 overlaps frame i's device decode)
            if _is_frame_pattern(src):
                frame_paths, warn = _collect_frames(src)
                if not frame_paths:
                    print(f"no frames match {src}", file=sys.stderr)
                    rc = 1
                    continue
                if warn:
                    print(warn, file=sys.stderr)
                if len(frame_paths) > 1 and not _is_frame_pattern(dst):
                    print(f"{len(frame_paths)} frames match {src} but "
                          f"destination {dst} has no %d pattern; outputs "
                          "would overwrite each other", file=sys.stderr)
                    rc = 1
                    continue
                streams = []
                for path in frame_paths:
                    with open(path, "rb") as f:
                        streams.append(f.read())
                t0 = time.perf_counter()
                outs = decoder.decode_batch(streams)
                ms = (time.perf_counter() - t0) * 1e3
                for fj, (raw, out_img) in enumerate(outs):
                    image_io.save_image(
                        dst % fj if _is_frame_pattern(dst) else dst,
                        raw, out_img)
                print(f"{src}: decoded {len(outs)} frames -> {dst} "
                      f"({ms / len(outs):.2f} ms/frame)")
                continue
            for it in range(args.iterate):
                t0 = time.perf_counter()
                raw, out_img = decoder.decode(jpeg)
                ms = (time.perf_counter() - t0) * 1e3
                _print_stats("Decode", decoder.stats, ms, args.verbose)
            image_io.save_image(dst, raw, out_img)
            if args.verbose:
                print(f"{src} -> {dst} ({out_img.width}x{out_img.height})")
        else:
            print(f"cannot deduce operation for {src} -> {dst}; "
                  "pass -e or -d", file=sys.stderr)
            rc = 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
