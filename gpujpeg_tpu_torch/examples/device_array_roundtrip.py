"""Round trip that stays on the device: a frame already in device memory
is encoded without a host copy, decoded with ``decode_to_device`` and
re-encoded from the decoder's tensor.

The analog of the reference's CUDA-buffer interop
(examples/decode_to_cuda_pnm.c, encode from GPU memory) and of the JAX
package's ``examples/device_array_roundtrip.py``.

Run:  python -m gpujpeg_tpu_torch.examples.device_array_roundtrip
          [--device cuda|cpu] [--size 320x256]
"""
import argparse

import numpy as np
import torch

from gpujpeg_tpu_torch import Decoder, Encoder, ImageParameters, Parameters
from gpujpeg_tpu_torch.types import ColorSpace, PixelFormat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", default="320x256", metavar="WxH")
    args = p.parse_args(argv)
    W, H = (int(v) for v in args.size.lower().split("x"))
    rng = np.random.default_rng(0)
    frame_host = np.clip(
        rng.normal(128, 30, (H, W, 3)), 0, 255).astype(np.uint8)
    # e.g. another model's output, already on the device
    frame_device = torch.from_numpy(frame_host).to(args.device)

    params = Parameters(quality=85, restart_interval=8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    enc = Encoder(device=args.device)
    data = enc.encode(frame_device, params, image)        # no host copy

    dec = Decoder(device=args.device)
    raw_device, out_image = dec.decode_to_device(data)    # stays on device
    print(type(raw_device).__name__, raw_device.dtype,
          getattr(raw_device, "device", "host"), out_image.width,
          out_image.height)
    data2 = enc.encode(raw_device, params, image)          # re-encode chain
    print(f"transcode: {len(data)} -> {len(data2)} bytes, no host copy")
    host = np.asarray(raw_device.cpu() if isinstance(raw_device, torch.Tensor)
                      else raw_device)
    mse = float(np.mean((host.reshape(-1).astype(np.float32)
                         - frame_host.reshape(-1)) ** 2))
    print(f"round-trip MSE: {mse:.1f}")
    return data, data2, host


if __name__ == "__main__":
    main()
