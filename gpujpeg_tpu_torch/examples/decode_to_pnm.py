"""Decode a JPEG file to a PNM image.

The analog of the reference's examples/decode_to_pnm.c (the JAX
package's ``examples/decode_to_pnm.py``).

Run:  python -m gpujpeg_tpu_torch.examples.decode_to_pnm
          [--device cuda|cpu] [src.jpg] [dst.pnm]
"""
import argparse

from gpujpeg_tpu_torch import Decoder
from gpujpeg_tpu_torch.utils import image_io


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("src", nargs="?", default="minimal.jpg")
    p.add_argument("dst", nargs="?", default="decoded.pnm")
    args = p.parse_args(argv)
    with open(args.src, "rb") as f:
        data = f.read()
    raw, image = Decoder(device=args.device).decode(data)
    image_io.save_image(args.dst, raw, image)
    print(f"wrote {args.dst} ({image.width}x{image.height})")


if __name__ == "__main__":
    main()
