"""Minimal encode: RGB array in, JPEG file out.

The analog of the reference's examples/encode_minimal.c (the JAX
package's ``examples/encode_minimal.py``).

Run:  python -m gpujpeg_tpu_torch.examples.encode_minimal
          [--device cuda|cpu] [--size 640x480] [--out minimal.jpg]
"""
import argparse

import numpy as np

from gpujpeg_tpu_torch import Encoder, ImageParameters, Parameters
from gpujpeg_tpu_torch.types import ColorSpace, PixelFormat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", default="640x480", metavar="WxH")
    p.add_argument("--out", default="minimal.jpg")
    args = p.parse_args(argv)
    W, H = (int(v) for v in args.size.lower().split("x"))
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([
        (x * 255 // W), (y * 255 // H), ((x + y) * 255 // (W + H))
    ], axis=-1).astype(np.uint8)

    params = Parameters(quality=90, restart_interval=8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(device=args.device).encode(img, params, image)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
