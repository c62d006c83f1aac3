"""``Decoder.decode``'s frame in host memory (``ops/pipeline.py``:
``copy_back``, ``pinned_like``). On the card: the bytes equal
``decode_to_device``'s frame, the array views page-locked memory, frames
held at once stay intact through later decodes, a dropped frame's block
serves the next decode of its size (the ``gpujpeg.dec.pin`` span's bytes
are 0) and the span lies inside ``gpujpeg.dec.memory_from``. On the CPU:
an unpinned array of the caller's own, byte-equal to the frame on the
device, no pin span, and the tracer's names at their indices.

The card tests skip without a card. The file needs nothing of
``conftest.py``, which imports JAX, so on a card's machine, which has no
JAX: ``python -m pytest --noconftest tests/test_torch_copy_back.py -q``."""
import numpy as np
import pytest
import torch

import gpujpeg_tpu_torch as port
from gpujpeg_tpu_torch import trace

#: the card's frames: 4:4:4 RGB at HD, interval 8 (240 segments a scan)
H, W = 1080, 1920
#: the CPU's frames, small enough for the plain versions
H_CPU, W_CPU = 64, 96

#: every span name before the pin span, at its index
NAMES_BEFORE = (
    "gpujpeg.enc", "gpujpeg.enc.plan", "gpujpeg.enc.context",
    "gpujpeg.enc.upload", "gpujpeg.enc.launch", "gpujpeg.enc.wait",
    "gpujpeg.enc.memory_from", "gpujpeg.enc.stream", "gpujpeg.dec",
    "gpujpeg.dec.stream", "gpujpeg.dec.plan", "gpujpeg.dec.context",
    "gpujpeg.dec.rows", "gpujpeg.dec.memory_to", "gpujpeg.dec.launch",
    "gpujpeg.dec.wait", "gpujpeg.dec.memory_from")


@pytest.fixture
def card():
    """The CUDA card, decided when a test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """A flat RGB frame of smooth gradients and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0),
                    128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0),
                    128 + 70 * np.sin((x + y) / 41.0)], axis=-1)
    img += rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8).reshape(-1)


def _streams(device, h: int, w: int, seeds=(7, 8, 9)) -> list:
    params = port.Parameters(quality=75, restart_interval=8)
    image = port.ImageParameters(width=w, height=h)
    enc = port.Encoder(backend="torch", device=device)
    return [enc.encode(_frame(h, w, seed), params, image)
            for seed in seeds]


def _names(s) -> list:
    return [trace.NAMES[c] for c in s["name"]]


def _pin_spans(s) -> np.ndarray:
    return s[np.asarray(_names(s)) == "gpujpeg.dec.pin"]


def test_names_keep_their_indices():
    assert trace.NAMES[:len(NAMES_BEFORE)] == NAMES_BEFORE
    assert trace.NAMES[len(NAMES_BEFORE)] == "gpujpeg.dec.pin"


def test_cpu_decode_is_unpinned_and_unchanged():
    data = _streams("cpu", H_CPU, W_CPU, seeds=(7,))[0]
    dec = port.Decoder(backend="torch", device="cpu")
    a, _ = dec.decode(data)
    b, _ = dec.decode(data)
    ref = dec.decode_to_device(data)[0].cpu().numpy()
    assert isinstance(a, np.ndarray) and a.dtype == np.uint8
    assert not torch.from_numpy(a).is_pinned()
    assert np.array_equal(a, ref) and np.array_equal(b, ref)
    assert not np.shares_memory(a, b)


def test_cpu_decode_records_no_pin_span():
    data = _streams("cpu", H_CPU, W_CPU, seeds=(7,))[0]
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.decode(data)
    s = trace.spans()
    assert "gpujpeg.dec.memory_from" in _names(s)
    assert _pin_spans(s).size == 0


def test_card_decode_equals_the_device_frame(card):
    dec = port.Decoder(backend="torch", device=card)
    for data in _streams(card, H, W):
        a, _ = dec.decode(data)
        ref = dec.decode_to_device(data)[0].cpu().numpy()
        assert a.dtype == np.uint8 and a.shape == ref.shape == (H * W * 3,)
        assert np.array_equal(a, ref)


def test_card_decode_is_pinned(card):
    dec = port.Decoder(backend="torch", device=card)
    a, _ = dec.decode(_streams(card, H, W, seeds=(7,))[0])
    assert torch.from_numpy(a).is_pinned()


def test_card_frames_held_at_once_stay_intact(card):
    """Two frames held while a third decode runs: neither is written."""
    s1, s2, s3 = _streams(card, H, W)
    dec = port.Decoder(backend="torch", device=card)
    refs = [dec.decode_to_device(s)[0].cpu().numpy() for s in (s1, s2, s3)]
    a, _ = dec.decode(s1)
    b, _ = dec.decode(s2)
    c, _ = dec.decode(s3)
    assert not np.shares_memory(a, b) and not np.shares_memory(b, c)
    assert not np.shares_memory(a, c)
    for got, ref in zip((a, b, c), refs):
        assert np.array_equal(got, ref)


def test_card_dropped_frame_block_is_reused(card):
    """Frames held take fresh page-locked memory (the span's bytes, at
    least the frame's); once the caller drops a frame, the next decode of
    its size takes none."""
    data = _streams(card, H, W, seeds=(7,))[0]
    dec = port.Decoder(backend="torch", device=card, perf_stats=True)
    held = []
    for _ in range(16):     # past the blocks that earlier tests left cached
        held.append(dec.decode(data)[0])
        if _pin_spans(trace.spans())["bytes"][-1] > 0:
            break
    fresh = int(_pin_spans(trace.spans())["bytes"][-1])
    assert fresh >= H * W * 3
    held.clear()
    dec.decode(data)        # the result dropped at once
    trace.clear()
    for _ in range(3):
        dec.decode(data)
    pins = _pin_spans(trace.spans())
    assert len(pins) == 3 and (pins["bytes"] == 0).all()


def test_card_pin_span_inside_memory_from(card):
    data = _streams(card, H, W, seeds=(7,))[0]
    dec = port.Decoder(backend="torch", device=card, perf_stats=True)
    dec.decode(data)
    s = trace.spans()
    names = _names(s)
    assert names.count("gpujpeg.dec.pin") == 1
    pin = names.index("gpujpeg.dec.pin")
    back = names.index("gpujpeg.dec.memory_from")
    assert s["parent"][pin] == back and s["parent"][back] == 0
    assert s["start_ns"][back] <= s["start_ns"][pin] <= s["end_ns"][pin] \
        <= s["end_ns"][back]
    assert s["bytes"][back] == H * W * 3
    assert dec.stats.duration_memory_from == \
        (int(s["end_ns"][back]) - int(s["start_ns"][back])) * 1e-6
