"""The port's image-file I/O (``gpujpeg_tpu_torch.utils.image_io``) and
reformatter (``gpujpeg_tpu_torch.tools.reformat``) against the JAX
package's: the cases of ``tests/test_image_io.py`` run through both on
the same inputs, with equal arrays, parameters and file bytes."""
import numpy as np
import pytest

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
from gpujpeg_tpu.tools import reformat as ref_reformat
from gpujpeg_tpu.utils import image_io as ref_io
from gpujpeg_tpu_torch.tools import reformat
from gpujpeg_tpu_torch.utils import image_io

MODS = ((image_io, port), (ref_io, ref))


def _params(pair):
    """(ImageParameters fields) of a port or JAX ImageParameters."""
    return (pair.width, pair.height, int(pair.color_space),
            int(pair.pixel_format))


def _save_load(tmp_path, name, flat, pf_name, W, H):
    """Save ``flat`` with each package's ``save_image``, load it back with
    its ``load_image``; return [(bytes, array, params)] for port, JAX."""
    out = []
    for io, mod in MODS:
        d = tmp_path / mod.__name__
        d.mkdir(exist_ok=True)
        path = str(d / name)
        io.save_image(path, flat, mod.ImageParameters(
            width=W, height=H, pixel_format=getattr(mod.PixelFormat,
                                                    pf_name)))
        data, info = io.load_image(path)
        with open(path, "rb") as f:
            out.append((f.read(), data, _params(info)))
    return out


def _same(out):
    (b, a, p), (rb, ra, rp) = out
    assert b == rb
    np.testing.assert_array_equal(a, ra)
    assert p == rp


def test_file_format_from_extension():
    for name in ("x.jpg", "x.JPEG", "x.pnm", "x.y4m", "x.i420", "x.r",
                 "noext", "x.pam", "x.rgba", "x.yuv"):
        assert (image_io.image_get_file_format(name).value
                == ref_io.image_get_file_format(name).value)


def test_ppm_round_trip(tmp_path, rng):
    img = rng.integers(0, 256, (24, 17, 3), dtype=np.uint8)
    _same(_save_load(tmp_path, "t.ppm", img.reshape(-1), "PF_444_U8_P012",
                     17, 24))


def test_pgm_round_trip(tmp_path, rng):
    img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    _same(_save_load(tmp_path, "t.pgm", img.reshape(-1), "U8", 16, 16))


def test_pam_alpha_round_trip(tmp_path, rng):
    img = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    _same(_save_load(tmp_path, "t.pam", img.reshape(-1), "PF_444_U8_P012A",
                     8, 8))


def _probe_and_load(path):
    out = []
    for io, _ in MODS:
        data, info = io.load_image(str(path))
        out.append((_params(io.image_get_properties(str(path))), data,
                    _params(info)))
    return out


def test_pnm_comment_and_probe(tmp_path):
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n10 5\n255\n" + bytes(10 * 5 * 3))
    _same(_probe_and_load(path))


def test_pbm_bitmap(tmp_path):
    path = tmp_path / "b.pnm"
    path.write_bytes(b"P4\n9 2\n" + bytes([0b10101010, 0b10000000,
                                          0b01010101, 0b00000000]))
    _same(_probe_and_load(path))


def test_plain_ascii_pnm_rejected(tmp_path):
    path = tmp_path / "a.pnm"
    path.write_bytes(b"P3\n1 1\n255\n1 2 3\n")
    msgs = []
    for io, _ in MODS:
        with pytest.raises(ValueError, match="ASCII") as e:
            io.load_image(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_y4m_multiframe_round_trip(tmp_path, rng):
    H, W = 16, 32
    frames = [rng.integers(0, 256, W * H * 3 // 2, dtype=np.uint8)
              for _ in range(3)]
    data = image_io.y4m_write(image_io.Y4mInfo(width=W, height=H,
                                               subsampling=420), frames)
    assert data == ref_io.y4m_write(ref_io.Y4mInfo(width=W, height=H,
                                                   subsampling=420), frames)
    path = tmp_path / "v.y4m"
    path.write_bytes(data)
    (info, got), (ref_info, ref_got) = (io.y4m_read_frames(data)
                                        for io, _ in MODS)
    assert vars(info) == vars(ref_info)
    for a, b in zip(got, ref_got):
        np.testing.assert_array_equal(a, b)
    _same(_probe_and_load(path))


def test_y4m_limited_range_and_mono(tmp_path):
    path = tmp_path / "m.y4m"
    path.write_bytes(b"YUV4MPEG2 W8 H8 F25:1 Cmono XCOLORRANGE=LIMITED\n"
                     b"FRAME\n" + bytes(range(64)))
    _same(_probe_and_load(path))


def test_raw_probe():
    for name in ("frame.rgb", "frame.i420", "frame.r", "frame.rgbz",
                 "frame.yuva"):
        assert (_params(image_io.image_get_properties(name, False))
                == _params(ref_io.image_get_properties(name, False)))


def test_image_range_info(rng):
    for pf, n in (("PF_444_U8_P012", 3), ("PF_420_U8_P0P1P2", 1.5),
                  ("U8", 1)):
        flat = rng.integers(3, 250, int(24 * 16 * n), dtype=np.uint8)
        assert (image_io.image_range_info(flat, 24, 16,
                                          getattr(port.PixelFormat, pf))
                == ref_io.image_range_info(flat, 24, 16,
                                           getattr(ref.PixelFormat, pf)))


@pytest.mark.parametrize("segment_info,ri,interleaved", [
    (True, 4, False), (False, 2, True), (True, 0, False)])
def test_reformat_matches_reference(segment_info, ri, interleaved):
    """The port's reformatter adds the same APP13 segment info as the
    JAX package's, to streams with and without segment info already."""
    img = make_test_rgb(48, 64)
    image = port.ImageParameters(width=64, height=48,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    params = port.Parameters(quality=80, restart_interval=ri,
                             interleaved=interleaved,
                             segment_info=segment_info)
    data = port.Encoder(backend="golden").encode(img.reshape(-1), params,
                                                 image)
    out = reformat.reformat(data)
    assert out == ref_reformat.reformat(data)
    raw, _ = port.Decoder(backend="golden").decode(out)
    np.testing.assert_array_equal(
        raw, port.Decoder(backend="golden").decode(data)[0])


def test_reformat_main(tmp_path, capsys):
    img = make_test_rgb(32, 32)
    image = port.ImageParameters(width=32, height=32,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    src = tmp_path / "in.jpg"
    src.write_bytes(port.Encoder(backend="golden").encode(
        img.reshape(-1), port.Parameters(restart_interval=2), image))
    assert reformat.main([str(src), str(tmp_path / "a.jpg")]) == 0
    assert ref_reformat.main([str(src), str(tmp_path / "b.jpg")]) == 0
    assert (tmp_path / "a.jpg").read_bytes() == \
        (tmp_path / "b.jpg").read_bytes()
    assert reformat.main([str(src)]) == 2
