"""``gpujpeg_tpu_torch.tools.soak`` on the CPU: its entry point and last
line, cases rebuilt alone from (seed, index), what counts as a failure
(one reproducing line, exit 1), what does not (``JpegParseError`` on a
corrupt stream), a CUDA error stopping the soak, and the comparison rules
of ``tools.checks`` that hold the card to the CPU route, run here with
both sides on the CPU."""
import json
import os

import numpy as np
import pytest

import gpujpeg_tpu_torch as port
from gpujpeg_tpu_torch.models.decoder import Decoder
from gpujpeg_tpu_torch.stream.reader import read_image
from gpujpeg_tpu_torch.tools import checks, soak


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_main_on_the_cpu_prints_its_line(capsys):
    assert soak.main(["--device", "cpu", "--cases", "2", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    line = _last_json(out)
    assert list(line) == ["cases", "failures", "oom", "cases_per_s", "card"]
    assert (line["cases"], line["failures"], line["oom"], line["card"]) == (
        2, 0, 0, "cpu")
    assert line["cases_per_s"] > 0
    assert "SOAK FAIL" not in out


def test_index_rebuilds_the_case_alone(monkeypatch, capsys):
    """``--index i`` runs the very case that a run reaches i-th: the same
    geometry, input and corrupt streams, from (seed, i) alone."""
    seen = []

    def record(co, c):
        seen.append((c, soak.raw_input(c)))
        return [], soak.Counter()
    monkeypatch.setattr(soak, "run_case", record)
    assert soak.main(["--device", "cpu", "--cases", "4", "--seed", "3"]) == 0
    assert [c["index"] for c, _ in seen] == [0, 1, 2, 3]
    run = seen[2]
    seen.clear()
    assert soak.main(["--device", "cpu", "--index", "2", "--seed", "3"]) == 0
    (c, raw), = seen
    assert c == run[0] and np.array_equal(raw, run[1])
    assert _last_json(capsys.readouterr().out)["cases"] == 1
    data = bytes(range(256)) * 4 + b"\xff\xda" + bytes(200)
    assert soak.corrupt_streams(data, c) == soak.corrupt_streams(data, run[0])
    assert soak.case(3, 2) != soak.case(4, 2)


def _patch_decode(monkeypatch, fn):
    """Make the torch backend's ``Decoder.decode`` call ``fn(self, data,
    orig)``; the golden decoder stays as it is."""
    orig = Decoder.decode

    def decode(self, data):
        if self.backend != "torch":
            return orig(self, data)
        return fn(self, data, orig)
    monkeypatch.setattr(Decoder, "decode", decode)


def test_a_raising_decoder_is_one_failure_line(monkeypatch, capsys):
    calls = []

    def first_raises(self, data, orig):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected decode fault")
        return orig(self, data)
    _patch_decode(monkeypatch, first_raises)
    assert soak.main(["--device", "cpu", "--index", "1", "--seed", "3"]) == 1
    out = capsys.readouterr().out
    fails = [s for s in out.splitlines() if s.startswith("SOAK FAIL")]
    c = soak.case(3, 1)
    assert fails == [f"SOAK FAIL seed=3 index=1 {soak.describe(c)}: decode: "
                     "RuntimeError: injected decode fault"]
    assert _last_json(out)["failures"] == 1


def test_a_parse_error_on_a_corrupt_stream_is_no_failure(monkeypatch,
                                                         capsys):
    """Every corrupt stream raising ``JpegParseError`` passes; the good
    stream still decodes."""
    bad_streams = set()
    corrupt = soak.corrupt_streams

    def record(data, c):
        bads = corrupt(data, c)
        bad_streams.update(b for _, b in bads)
        return bads

    def parse_error_if_bad(self, data, orig):
        if data in bad_streams:
            raise port.JpegParseError("injected")
        return orig(self, data)
    monkeypatch.setattr(soak, "corrupt_streams", record)
    _patch_decode(monkeypatch, parse_error_if_bad)
    assert soak.main(["--device", "cpu", "--cases", "2", "--seed", "3"]) == 0
    assert _last_json(capsys.readouterr().out)["failures"] == 0
    assert len(bad_streams) == 6


def test_a_cuda_error_stops_the_soak(monkeypatch, capsys):
    """An error of the CUDA runtime ends the run at its case: one line
    that says so, no case after it."""
    def illegal_address(self, data, orig):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    _patch_decode(monkeypatch, illegal_address)
    assert soak.main(["--device", "cpu", "--cases", "5", "--seed", "3",
                      "--threads", "2"]) == 1
    out = capsys.readouterr().out
    fails = [s for s in out.splitlines() if s.startswith("SOAK FAIL")]
    assert fails and all("CUDA error, soak stopped: decode" in s
                         for s in fails)
    assert _last_json(out)["cases"] <= 2


def _stream(ri=2):
    c = dict(seed=0, index=0, h=40, w=56, pf="PF_444_U8_P012", cs="RGB",
             q=85, ri=ri, interleaved=False, sub=420, period=(7, 11),
             noise=5)
    raw = soak.raw_input(c)
    params, image = soak.setup(c)
    return raw, params, image, port.Encoder(device="cpu").encode(
        raw, params, image)


def test_card_vs_cpu_names_the_segment_that_differs():
    """Both contexts on the CPU: equal streams pass; one byte changed in a
    segment (no coefficient at a tie, so outside any) is named."""
    raw, params, image, data = _stream()
    assert "in 0 segments" in checks.card_vs_cpu(raw, params, image, data,
                                                 data, device="cpu")
    info = read_image(data)
    segs = [(s, lo, hi) for s in info.scans for lo, hi in s.segments]
    k = 5
    scan, lo, hi = segs[k]
    pos = data.find(bytes(scan.data[lo:hi]))
    assert pos > 0
    off = next(i for i in range(pos, pos + hi - lo)
               if data[i] not in (0xFE, 0xFF))
    bad = bytearray(data)
    bad[off] ^= 0x01
    with pytest.raises(checks.CheckError, match=rf"in segments \[{k}\]"):
        checks.card_vs_cpu(raw, params, image, data, bytes(bad),
                           device="cpu")


def test_decode_pair_holds_coefficients_and_bytes():
    """The IDCT rule on the CPU: the CPU route's own decode passes, a
    byte moved by PIXEL_STEP passes, one moved further is named."""
    _, _, _, data = _stream()
    dec = soak.decoder(device="cpu")
    got, oi = dec.decode(data)
    assert checks.decode_pair(data, oi, got, "cpu") == 0
    moved = got.copy().reshape(-1)
    moved[7] = moved[7] + checks.PIXEL_STEP if moved[7] < 128 \
        else moved[7] - checks.PIXEL_STEP
    assert checks.decode_pair(data, oi, moved, "cpu") == checks.PIXEL_STEP
    moved[7] = 0 if moved[7] > 128 else 255
    with pytest.raises(checks.CheckError, match="differ by"):
        checks.decode_pair(data, oi, moved, "cpu")


def test_fresh_build_uses_a_new_dir_and_restores_the_old(monkeypatch,
                                                         tmp_path, capsys):
    """``--fresh-build`` points the build dir at a new empty dir in the
    per-user cache for the run, then removes it and restores the
    setting (on the CPU nothing is built there)."""
    from gpujpeg_tpu_torch import _build
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setenv("GPUJPEG_TPU_TORCH_BUILD_DIR", "/elsewhere")
    monkeypatch.setattr(_build, "_KERNELS", None)
    assert soak.main(["--device", "cpu", "--cases", "1", "--seed", "3",
                      "--fresh-build"]) == 0
    out = capsys.readouterr().out
    line = next(s for s in out.splitlines() if s.startswith("fresh build"))
    fresh = line.split(" into ")[1].split(" left ")[0]
    assert fresh.startswith(str(tmp_path / "gpujpeg_tpu_torch" / "fresh-"))
    assert line.endswith("left []") and not os.path.exists(fresh)
    assert os.environ["GPUJPEG_TPU_TORCH_BUILD_DIR"] == "/elsewhere"
    monkeypatch.setattr(_build, "_KERNELS", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        soak.fresh_build_dir()
