"""The port's examples (``gpujpeg_tpu_torch/examples/``) run on the CPU
at small sizes, their results held against the library's per-frame
calls."""
import os
import socket
import subprocess
import sys

import numpy as np

import gpujpeg_tpu_torch as gj
from gpujpeg_tpu_torch.examples import (decode_to_pnm,
                                        device_array_roundtrip,
                                        encode_minimal, multihost_video,
                                        sharded_encode, video_pipeline)
from gpujpeg_tpu_torch.utils import image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_encode_minimal_then_decode_to_pnm(tmp_path, capsys):
    jpg, pnm = str(tmp_path / "m.jpg"), str(tmp_path / "m.pnm")
    encode_minimal.main(["--device", "cpu", "--size", "96x64", "--out", jpg])
    decode_to_pnm.main(["--device", "cpu", jpg, pnm])
    assert "wrote" in capsys.readouterr().out
    with open(jpg, "rb") as f:
        data = f.read()
    raw, image = gj.Decoder(device="cpu").decode(data)
    got, info = image_io.load_image(pnm)
    assert (info.width, info.height) == (96, 64) == (image.width,
                                                     image.height)
    np.testing.assert_array_equal(got, raw)


def test_device_array_roundtrip():
    # 128x96 at restart interval 8: 72 segments, the device route
    data, data2, host = device_array_roundtrip.main(
        ["--device", "cpu", "--size", "128x96"])
    params = gj.Parameters(quality=85, restart_interval=8)
    image = gj.ImageParameters(width=128, height=96,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)
    assert host.size == 128 * 96 * 3
    assert data2 == gj.Encoder(device="cpu").encode(host, params, image)


def test_video_pipeline():
    frames, jpegs, outs = video_pipeline.main(
        ["--device", "cpu", "--size", "96x64", "--frames", "3"])
    params = gj.Parameters(quality=85, restart_interval=16)
    image = gj.ImageParameters(width=96, height=64,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)
    enc = gj.Encoder(device="cpu")
    assert jpegs == [enc.encode(f, params, image) for f in frames]
    dec = gj.Decoder(device="cpu")
    dec.set_output_format(gj.ColorSpace.RGB, gj.PixelFormat.PF_444_U8_P012)
    for (raw, _), data in zip(outs, jpegs):
        np.testing.assert_array_equal(raw, dec.decode(data)[0])


def test_sharded_encode(capsys):
    data, single, raw, want = sharded_encode.main(
        ["--device", "cpu", "--bands", "4", "--size", "160x128"])
    assert data == single
    np.testing.assert_array_equal(raw, want)
    assert "4 bands on cpu" in capsys.readouterr().out


def test_multihost_video_one_process():
    frames, streams, outs = multihost_video.main(
        ["--device", "cpu", "--bands", "2", "--size", "160x128"])
    params = gj.Parameters(quality=85, restart_interval=4)
    image = gj.ImageParameters(width=160, height=128,
                               color_space=gj.ColorSpace.RGB,
                               pixel_format=gj.PixelFormat.PF_444_U8_P012)
    enc, dec = gj.Encoder(device="cpu"), gj.Decoder(device="cpu")
    assert streams == [enc.encode(f, params, image) for f in frames]
    for (raw, _), data in zip(outs, streams):
        np.testing.assert_array_equal(raw, dec.decode(data)[0])


def test_multihost_video_two_processes():
    """``pid nproc addr`` as the JAX example takes them: two processes
    joined over gloo on this machine."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gpujpeg_tpu_torch.examples.multihost_video",
         str(pid), "2", addr, "--device", "cpu", "--bands", "2", "--size",
         "160x128"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"process {pid}: encoded" in out
        assert "equal to one device's streams: True" in out
        assert out.count(f"process {pid}: round-trip PSNR") == 2
