"""The port's examples (``gpujpeg_tpu_torch/examples/``) run on the CPU
at small sizes, their results held against the library's per-frame
calls."""
import numpy as np

import gpujpeg_tpu_torch as gj
from gpujpeg_tpu_torch.examples import (decode_to_pnm,
                                        device_array_roundtrip,
                                        encode_minimal, video_pipeline)
from gpujpeg_tpu_torch.utils import image_io


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
