"""Pipelined video round trip: encode_batch + decode_batch.

The analog of the reference's per-stream frame loop (test/misc/
mt_encode.c and the ``-n`` iteration flow, src/main.c:546-597) and of
the JAX package's ``examples/video_pipeline.py``: device work for a
window of frames queues ahead of each frame's copy back and host stream
assembly, and on decode the host parse and segment-row build of frame
i+1 run under frame i's device work.

Run:  python -m gpujpeg_tpu_torch.examples.video_pipeline
          [--device cuda|cpu] [--size 1280x720] [--frames 16]
"""
import argparse
import time

import numpy as np

import gpujpeg_tpu_torch as gj


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", default="1280x720", metavar="WxH")
    p.add_argument("--frames", type=int, default=16)
    args = p.parse_args(argv)
    W, H = (int(v) for v in args.size.lower().split("x"))
    n = args.frames

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:H, 0:W]
    frames = []
    for i in range(n):
        f = np.stack([
            128 + 90 * np.sin(x / 23.0 + i / 3) * np.cos(y / 17.0),
            128 + 80 * np.cos(x / 31.0) * np.sin(y / 11.0 + i / 5),
            128 + 70 * np.sin((x + y) / 41.0)], axis=-1)
        frames.append(np.clip(f + rng.normal(0, 2, f.shape), 0,
                              255).astype(np.uint8))

    params = gj.Parameters(quality=85, restart_interval=16)
    image = gj.ImageParameters(width=W, height=H,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)

    enc = gj.Encoder(device=args.device)
    enc.warmup(params, image)          # build and set up outside the loop

    t0 = time.perf_counter()
    jpegs = enc.encode_batch(frames, params, image)
    dt = time.perf_counter() - t0
    print(f"encode_batch: {n} frames in {dt*1e3:.1f} ms "
          f"({n/dt:.1f} fps, {sum(map(len, jpegs))/1e6:.2f} MB total)")

    dec = gj.Decoder(device=args.device)
    dec.set_output_format(gj.ColorSpace.RGB, gj.PixelFormat.PF_444_U8_P012)
    dec.decode(jpegs[0])               # set up outside the loop

    t0 = time.perf_counter()
    outs = dec.decode_batch(jpegs)
    dt = time.perf_counter() - t0
    print(f"decode_batch: {n} frames in {dt*1e3:.1f} ms ({n/dt:.1f} fps)")

    raw0 = outs[0][0].reshape(H, W, 3)
    mse = np.mean((raw0.astype(np.float64) - frames[0]) ** 2)
    print(f"frame 0 PSNR: {10*np.log10(255.0**2/mse):.2f} dB")
    return frames, jpegs, outs


if __name__ == "__main__":
    main()
