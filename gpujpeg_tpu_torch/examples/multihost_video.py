"""Multi-process video pipeline: frames sharded across processes, each
frame's MCU-row bands across that process's local devices — encode and
decode.

The counterpart of the JAX package's ``examples/multihost_video.py``.
Launch one process a host (or a card); give each its rank, the process
count and the first process's address, for example two processes on
one machine:

    python -m gpujpeg_tpu_torch.examples.multihost_video 0 2 localhost:9876 &
    python -m gpujpeg_tpu_torch.examples.multihost_video 1 2 localhost:9876

Under torchrun (``WORLD_SIZE`` set) it takes no positional arguments;
without either it runs as a world of one process. The local devices are
the CUDA devices, one band each, or ``--bands N`` bands on ``--device``.

Run:  python -m gpujpeg_tpu_torch.examples.multihost_video [pid nproc addr]
          [--device cuda|cpu] [--bands N] [--size 320x256]
"""
import argparse
import os

import numpy as np

from gpujpeg_tpu_torch import Encoder, ImageParameters, Parameters
from gpujpeg_tpu_torch.parallel import (Mesh, MultiHostDecoder,
                                        MultiHostEncoder, global_mesh,
                                        init_distributed)
from gpujpeg_tpu_torch.parallel.sharded import local_cuda_mesh
from gpujpeg_tpu_torch.types import ColorSpace, PixelFormat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cluster", nargs="*", metavar="pid nproc addr")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bands", type=int, default=0,
                   help="bands on --device (default: one on each CUDA "
                        "device)")
    p.add_argument("--size", default="320x256", metavar="WxH")
    args = p.parse_args(argv)
    if args.cluster:
        if len(args.cluster) != 3:
            p.error("give pid, nproc and addr, or none of them")
        pid, nproc, addr = args.cluster
        init_distributed(addr, num_processes=int(nproc),
                         process_id=int(pid))
    elif "WORLD_SIZE" in os.environ:
        init_distributed()
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.bands:
        local = [args.device] * args.bands
    elif args.device == "cuda":
        local = list(local_cuda_mesh().devices[0])
    else:
        p.error("--bands is needed with a --device other than cuda")

    W, H = (int(v) for v in args.size.lower().split("x"))
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=85, restart_interval=4)
    # each process owns its own frames (e.g. its slice of a video)
    rng = np.random.default_rng(100 + rank)
    y, x = np.mgrid[0:H, 0:W]
    frames = [np.clip(np.stack([128 + 90 * np.sin(x / (21.0 + f)),
                                128 + 80 * np.cos(y / 17.0),
                                128 + 70 * np.sin((x + y) / 31.0)], -1)
                      + rng.normal(0, 2, (H, W, 3)), 0, 255)
              .astype(np.uint8) for f in range(2)]

    streams = MultiHostEncoder(global_mesh(local_devices=local)) \
        .encode_my_frames(frames, params, image)
    single = Encoder(device=local[0])
    same = all(s == single.encode(f, params, image)
               for f, s in zip(frames, streams))
    print(f"process {rank}: encoded {[len(s) for s in streams]} bytes on "
          f"{len(local)} bands; equal to one device's streams: {same}")

    outs = MultiHostDecoder(Mesh([local])).decode_my_frames(streams)
    for frame, (raw, _) in zip(frames, outs):
        got = np.asarray(raw).reshape(H, W, 3).astype(np.int64)
        mse = np.mean((got - frame.astype(np.int64)) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
        print(f"process {rank}: round-trip PSNR {psnr:.2f} dB")
        if psnr <= 30:
            raise SystemExit(f"process {rank}: PSNR {psnr:.2f} dB")
    if dist.is_initialized():
        dist.destroy_process_group()
    return frames, streams, outs


if __name__ == "__main__":
    main()
