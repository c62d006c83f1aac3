"""The frozen roofline arithmetic reads the bounds the configurations'
shapes give."""
import pytest

from portbench import bounds, spec
from portbench.reference.geometry import make_geometry


def geometry(cfg):
    return make_geometry(cfg["width"], cfg["height"], cfg["sampling"],
                         cfg["interleaved"], cfg["restart_interval"])


def test_constants():
    assert bounds.DCT_BLOCK_FLOPS == 2176
    assert bounds.COLOUR_BLOCK_FLOPS == 384


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_still_8k(direction):
    cfg = spec.load_cell("still8k.host").config
    geo = geometry(cfg)
    assert geo.n_blocks == 1_555_200 and geo.n_segments == 48_600
    t, by = bounds.frame_bound(cfg, geo, 4.29e6, direction)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.0594, abs=5e-5)
    assert t == pytest.approx(1_555_200 * 2_560 / 67e12)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_video_hd(direction):
    cfg = spec.load_cell("video_hd.device").config
    geo = geometry(cfg)
    assert geo.n_blocks == 48_960 and geo.n_segments == 2_040
    t, by = bounds.frame_bound(cfg, geo, 0.4e6, direction)
    assert by == "operations"
    assert t * 1e6 == pytest.approx(1.59, abs=0.01)


def test_bytes_bound():
    t, by = bounds.bound(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
