"""Sharded encode: one image's MCU-row bands across devices, then the
sharded decode back.

The counterpart of the JAX package's ``examples/sharded_encode.py`` (the
capability the single-GPU reference lacks). By default the mesh holds
one band on each CUDA device; ``--bands N`` puts N bands on ``--device``
(several bands on one card, or on the CPU).

Run:  python -m gpujpeg_tpu_torch.examples.sharded_encode
          [--device cuda|cuda:0|cpu] [--bands N] [--size 640x512]
"""
import argparse
import dataclasses

import numpy as np

from gpujpeg_tpu_torch import (Decoder, Encoder, ImageParameters,
                               Parameters)
from gpujpeg_tpu_torch.parallel import (Mesh, ShardedDecoder, ShardedEncoder,
                                        choose_restart_interval)
from gpujpeg_tpu_torch.types import ColorSpace, PixelFormat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--bands", type=int, default=0,
                   help="bands on --device (default: one on each CUDA "
                        "device)")
    p.add_argument("--size", default="640x512", metavar="WxH")
    args = p.parse_args(argv)
    W, H = (int(v) for v in args.size.lower().split("x"))
    y, x = np.mgrid[0:H, 0:W]
    img = np.clip(np.stack([128 + 90 * np.sin(x / 23.0),
                            128 + 80 * np.cos(y / 17.0),
                            128 + 70 * np.sin((x + y) / 31.0)], axis=-1),
                  0, 255).astype(np.uint8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)

    if args.bands:
        mesh = Mesh([[args.device] * args.bands])
    elif args.device == "cuda":
        mesh = None                  # one band on each CUDA device
    else:
        p.error("--bands is needed with a --device other than cuda")
    enc = ShardedEncoder(mesh)
    n = enc.n_seg
    params = Parameters(quality=85)
    ri = choose_restart_interval(params, image, n)
    params = dataclasses.replace(params, restart_interval=ri)

    data = enc.encode(img, params, image)
    device = enc.mesh.devices[0, 0]
    single = Encoder(device=device).encode(img, params, image)
    raw, _ = ShardedDecoder(enc.mesh).decode(data)
    want, _ = Decoder(device=device).decode(data)
    devices = ", ".join(str(d) for d in enc.mesh.devices[0])
    print(f"{n} bands on {devices}, restart interval {ri}: {len(data)} "
          f"bytes; equal to one device's stream: {data == single}; "
          f"sharded decode equal to one device's: "
          f"{np.array_equal(raw, want)}")
    return data, single, raw, want


if __name__ == "__main__":
    main()
