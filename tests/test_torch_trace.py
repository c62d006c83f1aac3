"""The port's tracer (``gpujpeg_tpu_torch.trace``): the spans of one
encode and one decode on the CPU, their nesting, call ids and byte
counts; nothing recorded and no buffer allocated without perf stats, and
no code of the tracer run at all; the overflow count; the spans as
``torch.profiler`` user annotations; the stats that time a span's
interval taken from its two clock readings; a failed call's spans closed;
the batch and sharded paths' root spans; spans from several threads."""
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu_torch as port
from gpujpeg_tpu_torch import parallel as par
from gpujpeg_tpu_torch import tables, trace
from gpujpeg_tpu_torch.models.decoder import DecoderStats
from gpujpeg_tpu_torch.models.encoder import EncoderStats
from gpujpeg_tpu_torch.ops.decode import scan_bytes
from gpujpeg_tpu_torch.stream.reader import read_image

H, W = 64, 96
ENC = ["gpujpeg.enc", "gpujpeg.enc.plan", "gpujpeg.enc.context",
       "gpujpeg.enc.upload", "gpujpeg.enc.launch", "gpujpeg.enc.wait",
       "gpujpeg.enc.memory_from", "gpujpeg.enc.stream"]
FRESH = "gpujpeg.dec.tables_fresh"
CARD = "gpujpeg.dec.card_rows"
DEC = ["gpujpeg.dec", "gpujpeg.dec.stream", FRESH, "gpujpeg.dec.plan",
       "gpujpeg.dec.context", "gpujpeg.dec.rows", "gpujpeg.dec.memory_to",
       "gpujpeg.dec.launch", "gpujpeg.dec.wait", CARD,
       "gpujpeg.dec.memory_from"]
#: the decode's spans that open a profiler range: all but the counters
DEC_RANGES = [n for n in DEC if n not in (FRESH, CARD)]


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    tables.clear_dht_tables()
    yield
    trace.clear()


def _params(sub: int = 444, ri: int = 1, **kw):
    p = port.Parameters(quality=75, restart_interval=ri, **kw)
    return p.with_chroma_subsampling(sub) if sub != 444 else p


def _image():
    return port.ImageParameters(width=W, height=H)


def _stream(sub: int = 444) -> bytes:
    return port.Encoder(backend="torch", device="cpu").encode(
        make_test_rgb(H, W).reshape(-1), _params(sub), _image())


def _names(s) -> list:
    return [trace.NAMES[c] for c in s["name"]]


def _check_call(s, names: list, base: int = 0) -> None:
    """``s``: the spans of one call, its root at index ``base`` of the
    buffer: the root first, each other span a child of it, inside it,
    with its own call id shared by all."""
    assert _names(s) == names
    assert s["parent"][0] == -1
    assert (s["parent"][1:] == base).all()
    assert (s["call"] == s["call"][0]).all()
    assert (s["end_ns"] >= s["start_ns"]).all() and (s["start_ns"] > 0).all()
    assert (s["start_ns"][1:] >= s["start_ns"][0]).all()
    assert (s["end_ns"][1:] <= s["end_ns"][0]).all()
    # the children one after another
    assert (s["start_ns"][2:] >= s["end_ns"][1:-1]).all()


@pytest.mark.parametrize("sub,as_tensor", [(444, False), (420, False),
                                           (444, True)])
def test_encode_records_its_spans(sub, as_tensor):
    """The E1 route (4:4:4) and E0 + E1p (4:2:0); a frame already on the
    encoder's device moves no bytes."""
    img = make_test_rgb(H, W).reshape(-1)
    raw = torch.from_numpy(img.copy()) if as_tensor else img
    enc = port.Encoder(backend="torch", device="cpu")
    data = enc.encode(raw, _params(sub, perf_stats=True), _image())
    s = trace.spans()
    _check_call(s, ENC)
    assert trace.dropped() == 0
    nbytes = dict(zip(_names(s), s["bytes"].tolist()))
    assert nbytes["gpujpeg.enc.upload"] == (0 if as_tensor else img.nbytes)
    assert nbytes["gpujpeg.enc.memory_from"] == sum(
        sc.data.size for sc in read_image(data).scans)
    assert sum(nbytes.values()) == nbytes["gpujpeg.enc.upload"] + \
        nbytes["gpujpeg.enc.memory_from"]
    assert data == port.Encoder(backend="torch", device="cpu").encode(
        raw, _params(sub), _image())


@pytest.mark.parametrize("sub,pf,to_device", [
    (444, port.PixelFormat.PF_444_U8_P012, False),    # D1 -> D2
    (420, port.PixelFormat.PF_420_U8_P0P1P2, False),  # D1 -> D2p -> D3
    (420, port.PixelFormat.PF_420_U8_P0P1P2, True)])
def test_decode_records_its_spans(sub, pf, to_device):
    data = _stream(sub)
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.set_output_format(port.ColorSpace.RGB if sub == 444
                          else port.ColorSpace.YCBCR_BT601_256LVLS, pf)
    raw, _ = dec.decode_to_device(data) if to_device else dec.decode(data)
    s = trace.spans()
    _check_call(s, DEC[:-1] if to_device else DEC)
    nbytes = dict(zip(_names(s), s["bytes"].tolist()))
    job = dec._job(read_image(data))
    # the bytes uploaded: the scans' and the segments' int32 ranges
    up = sum(sd.size for sd in job.scan_data) + 8 * job.plan.n_segments
    assert nbytes["gpujpeg.dec.rows"] == nbytes["gpujpeg.dec.memory_to"] \
        == up == dec.stats.bytes_memory_to
    assert up == scan_bytes(job.plan, job.scan_data,
                            job.segments_by_scan).nbytes
    if not to_device:
        assert nbytes["gpujpeg.dec.memory_from"] == raw.nbytes == \
            port.types.image_calculate_size(W, H, pf)
    # the counters' values: the stream's 4 tables, derived fresh, and
    # every segment's row built on the device
    assert nbytes[FRESH] == 4 and nbytes[CARD] == job.plan.n_segments
    assert sum(nbytes.values()) == 2 * up + (
        0 if to_device else raw.nbytes) + nbytes[FRESH] + nbytes[CARD]


def test_one_call_id_a_call():
    enc = port.Encoder(backend="torch", device="cpu")
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    img = make_test_rgb(H, W).reshape(-1)
    for _ in range(2):
        data = enc.encode(img, _params(perf_stats=True), _image())
        dec.decode(data)
    s = trace.spans()
    roots = np.flatnonzero(s["parent"] == -1)
    assert _names(s[roots]) == ["gpujpeg.enc", "gpujpeg.dec"] * 2
    assert len(set(s["call"][roots].tolist())) == 4
    for a, b in zip(roots, list(roots[1:]) + [len(s)]):
        _check_call(s[a:b], ENC if _names(s[a:a + 1]) == ["gpujpeg.enc"]
                    else DEC, a)


def test_off_records_nothing_and_runs_no_tracer_code(monkeypatch):
    """Without perf stats a span site is a ``None`` check: no code of the
    tracer runs (no object, no clock reading, no profiler range), nothing
    is recorded and no buffer is allocated."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "record_function", no_range)
    data = _stream()
    enc = port.Encoder(backend="torch", device="cpu")
    dec = port.Decoder(backend="torch", device="cpu")
    img = make_test_rgb(H, W).reshape(-1)
    ran = []

    def watch(frame, event, arg):
        if event == "call" and frame.f_code.co_filename == trace.__file__:
            ran.append(frame.f_code.co_name)

    sys.setprofile(watch)
    try:
        enc.encode(img, _params(), _image())
        dec.decode(data)
        dec.decode_to_device(data)
        enc.encode_batch([img], _params(), _image())
        dec.decode_batch([data])
    finally:
        sys.setprofile(None)
    assert ran == []
    assert trace._buf is None
    assert trace.spans().size == 0 and trace.dropped() == 0
    # the stats that perf stats do not gate are still filled
    assert enc.stats.duration_stream > 0 and dec.stats.duration_stream > 0
    assert dec.stats.duration_memory_to > 0


def test_overflow_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    enc = port.Encoder(backend="torch", device="cpu")
    enc.encode(make_test_rgb(H, W).reshape(-1), _params(perf_stats=True),
               _image())
    assert trace.dropped() == len(ENC) - 5
    assert _names(trace.spans()) == ENC[:5]
    assert (trace.spans()["end_ns"] > 0).all()
    trace.clear()
    assert trace.dropped() == 0 and trace.spans().size == 0


def test_spans_are_read_only():
    port.Encoder(backend="torch", device="cpu").encode(
        make_test_rgb(H, W).reshape(-1), _params(perf_stats=True), _image())
    s = trace.spans()
    with pytest.raises(ValueError):
        s["end_ns"][0] = 0


def test_spans_are_profiler_user_annotations(monkeypatch):
    """Under ``torch.profiler`` each span is a ``record_function`` range of
    its name, inside its parent's; outside it no range is entered."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    entered = []
    real = trace.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(trace, "record_function", counting)
    data = _stream(420)
    enc = port.Encoder(backend="torch", device="cpu")
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    img = make_test_rgb(H, W).reshape(-1)
    enc.encode(img, _params(perf_stats=True), _image())
    dec.decode(data)
    assert entered == []
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc.encode(img, _params(perf_stats=True), _image())
        dec.decode(data)
    assert entered == ENC + DEC_RANGES
    ann = [(e.start_ns(), e.end_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    assert sorted(n for *_, n in ann) == sorted(ENC + DEC_RANGES)
    by_name = {n: (a, b) for a, b, n in ann}
    for root, names in (("gpujpeg.enc", ENC), ("gpujpeg.dec", DEC_RANGES)):
        r0, r1 = by_name[root]
        for n in names[1:]:
            assert r0 <= by_name[n][0] <= by_name[n][1] <= r1
    # the buffer kept the same spans on the process's own clock
    assert _names(trace.spans()) == ENC + DEC


def test_stats_keys_unchanged_and_taken_from_the_spans():
    assert list(EncoderStats().asdict()) == [
        "duration_memory_to", "duration_preprocessor",
        "duration_dct_quantization", "duration_huffman_coder",
        "duration_memory_from", "duration_stream", "duration_in_gpu"]
    assert list(DecoderStats().asdict()) == [
        "duration_stream", "duration_memory_to", "duration_huffman_coder",
        "duration_dct_quantization", "duration_postprocessor",
        "duration_memory_from", "duration_in_gpu", "bytes_memory_to"]
    enc = port.Encoder(backend="torch", device="cpu")
    data = enc.encode(make_test_rgb(H, W).reshape(-1),
                      _params(perf_stats=True), _image())
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.decode(data)
    s = trace.spans()
    span = {n: (int(a), int(b)) for n, a, b in
            zip(_names(s), s["start_ns"], s["end_ns"])}

    def ms(name):
        a, b = span[name]
        return (b - a) * 1e-6

    assert enc.stats.duration_stream == ms("gpujpeg.enc.stream")
    assert enc.stats.duration_in_gpu == (
        span["gpujpeg.enc.wait"][1] - span["gpujpeg.enc.upload"][0]) * 1e-6
    st = dec.stats
    assert st.duration_stream == ms("gpujpeg.dec.stream")
    assert st.duration_memory_to == ms("gpujpeg.dec.memory_to")
    assert st.duration_memory_from == ms("gpujpeg.dec.memory_from")
    assert st.duration_in_gpu == (
        span["gpujpeg.dec.wait"][1] - span["gpujpeg.dec.memory_to"][1]) * 1e-6
    # the device marks still fill the kernels' stages
    assert st.duration_huffman_coder > 0 and st.duration_dct_quantization > 0
    assert enc.stats.duration_dct_quantization > 0
    assert enc.stats.duration_huffman_coder > 0


def test_failed_calls_close_their_spans():
    enc = port.Encoder(backend="torch", device="cpu")
    with pytest.raises(ValueError):
        enc.encode(np.zeros(10, np.uint8), _params(perf_stats=True),
                   _image())
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    with pytest.raises(port.JpegParseError):
        dec.decode(b"\xff\xd8\xff\xd9")
    s = trace.spans()
    assert _names(s) == ENC[:4] + DEC[:2]
    assert (s["end_ns"] >= s["start_ns"]).all()
    assert len(set(s["call"].tolist())) == 2


def test_golden_batch_and_sharded_paths_get_their_root():
    """The golden route has no device step; the pipelined batches and the
    sharded encoder are one root span a call."""
    img = make_test_rgb(H, W).reshape(-1)
    data = _stream()
    gold = port.Encoder(backend="golden")
    gold.encode(img, _params(perf_stats=True), _image())
    assert _names(trace.spans()) == ["gpujpeg.enc", "gpujpeg.enc.plan",
                                     "gpujpeg.enc.stream"]
    trace.clear()
    enc = port.Encoder(backend="torch", device="cpu")
    enc.encode_batch([img, img], _params(perf_stats=True), _image())
    port.Decoder(backend="torch", device="cpu",
                 perf_stats=True).decode_batch([data, data])
    par.ShardedEncoder(par.Mesh([["cpu", "cpu"]])).encode(
        img, _params(perf_stats=True), _image())
    s = trace.spans()
    assert _names(s) == ["gpujpeg.enc", "gpujpeg.dec", "gpujpeg.enc"]
    assert (s["parent"] == -1).all() and len(set(s["call"].tolist())) == 3


def test_spans_from_threads():
    """Threads trace at once, switching often: every span kept once, each
    nested in its own call."""
    n_threads, calls, depth = 8, 200, 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(calls):
            tr = trace.Tracer(torch.device("cpu"), "gpujpeg.enc")
            for _ in range(depth):
                tr.open("gpujpeg.enc.launch")
                tr.close(1)
            tr.finish()

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = trace.spans()
    assert len(s) == n_threads * calls * (depth + 1)
    assert trace.dropped() == 0
    roots = s["parent"] == -1
    assert roots.sum() == n_threads * calls
    assert len(set(s["call"][roots].tolist())) == n_threads * calls
    kids = np.flatnonzero(~roots)
    assert (s["call"][s["parent"][kids]] == s["call"][kids]).all()
    assert roots[s["parent"][kids]].all()
    assert (s["end_ns"] >= s["start_ns"]).all()
    assert s["bytes"][kids].sum() == len(kids)


def test_perf_trace_tool_on_the_cpu(capsys):
    """``tools.perf_trace`` runs its three states and the site costs on the
    plain versions; the span counts a call are the tracer's."""
    from gpujpeg_tpu_torch.tools import perf_trace
    assert perf_trace.main(["hd", "--device", "cpu", "--scale", "8",
                            "--turns", "1", "--calls", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("perf_trace hd ")]
    assert [ln.split(":")[0] for ln in lines] == [
        f"perf_trace hd {p} {s}" for p in ("encode", "decode")
        for s in perf_trace.STATES]
    assert "8.0 spans a call" in lines[1] and "0.0 spans" in lines[0]
    assert trace.spans().size == 0


#: every name of the tracer before the lane route's, at its index
NAMES_BEFORE_LANES = tuple(ENC + DEC_RANGES) + ("gpujpeg.dec.pin",)


def test_names_keep_their_indices():
    """Names are appended, never moved: the lane route's two follow, then
    the parse's counter, then D0's."""
    assert trace.NAMES[:len(NAMES_BEFORE_LANES)] == NAMES_BEFORE_LANES
    assert trace.NAMES[len(NAMES_BEFORE_LANES):] == (
        "gpujpeg.dec.lanes", "gpujpeg.dec.rounds", FRESH, CARD)


def _restartless(sub: int = 420) -> bytes:
    return port.Encoder(backend="golden").encode(
        make_test_rgb(H, W).reshape(-1),
        _params(sub, ri=0, interleaved=True), _image())


@pytest.mark.parametrize("to_device", [False, True])
def test_lane_route_records_lanes_and_rounds(monkeypatch, to_device):
    """A stream without restart markers on the device route: one
    ``gpujpeg.dec.lanes`` span inside ``gpujpeg.dec.launch``, its count
    the lanes launched, and one ``gpujpeg.dec.rounds`` counter of no
    duration after the wait, its count the rounds; a call each."""
    import gpujpeg_tpu_torch.models.decoder as dmod
    from gpujpeg_tpu_torch.ops import pipeline
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    seen = []
    real = pipeline.huffman_lanes

    def counting(rows, geo, *a):
        out = real(rows, geo, *a)
        seen.append((int(geo[1]), int(out[1][0])))
        return out

    monkeypatch.setattr(pipeline, "huffman_lanes", counting)
    data = _restartless()
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    for _ in range(2):
        dec.decode_to_device(data) if to_device else dec.decode(data)
    s = trace.spans()
    names = _names(s)
    roots = np.flatnonzero(s["parent"] == -1)
    assert len(roots) == 2 and len(seen) == 2
    for k, root in enumerate(roots):
        end = roots[k + 1] if k + 1 < len(roots) else len(s)
        call = s[root:end]
        got = _names(call)
        assert got.count("gpujpeg.dec.lanes") == 1
        assert got.count("gpujpeg.dec.rounds") == 1
        lane = root + got.index("gpujpeg.dec.lanes")
        assert names[s["parent"][lane]] == "gpujpeg.dec.launch"
        assert s["start_ns"][lane] >= s["start_ns"][s["parent"][lane]]
        assert s["end_ns"][lane] <= s["end_ns"][s["parent"][lane]]
        rnd = root + got.index("gpujpeg.dec.rounds")
        assert s["parent"][rnd] == root
        assert s["start_ns"][rnd] == s["end_ns"][rnd]
        wait = root + got.index("gpujpeg.dec.wait")
        assert s["start_ns"][rnd] >= s["end_ns"][wait]
        assert (s["bytes"][lane], s["bytes"][rnd]) == seen[k]
        assert seen[k][1] >= 1
    # the other spans as on every device-route call, without D0's counter
    assert [n for n in got if n not in ("gpujpeg.dec.lanes",
                                        "gpujpeg.dec.rounds")] \
        == [n for n in (DEC[:-1] if to_device else DEC) if n != CARD]


def test_lane_route_records_nothing_without_perf_stats(monkeypatch):
    import gpujpeg_tpu_torch.models.decoder as dmod
    monkeypatch.setattr(dmod, "CPU_BLOCK_THRESHOLD", 0)
    data = _restartless()
    dec = port.Decoder(backend="torch", device="cpu")
    dec.decode(data)
    dec.decode_to_device(data)
    dec.decode_batch([data])
    assert trace._buf is None and trace.spans().size == 0


@pytest.mark.parametrize("ri", [1, 4])
def test_restart_intervals_record_no_lane_spans(monkeypatch, ri):
    import gpujpeg_tpu_torch.models.decoder as dmod
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    data = port.Encoder(backend="torch", device="cpu").encode(
        make_test_rgb(H, W).reshape(-1), _params(420, ri=ri), _image())
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    dec.decode(data)
    _check_call(trace.spans(), DEC)


@pytest.mark.parametrize("to_device", [False, True])
def test_decode_counts_the_tables_its_parse_derived(to_device):
    """``gpujpeg.dec.tables_fresh``: a counter of no duration in the root,
    between the parse and the plan, its count the DHT tables the parse
    derived: the stream's 4, then 0 on the next call, which shares them.
    An untraced decode records nothing."""
    data = _stream(420)
    dec = port.Decoder(backend="torch", device="cpu", perf_stats=True)
    for _ in range(2):
        dec.decode_to_device(data) if to_device else dec.decode(data)
    s = trace.spans()
    names = _names(s)
    at = [i for i, n in enumerate(names) if n == FRESH]
    assert s["bytes"][at].tolist() == [4, 0]
    for i in at:
        assert names[s["parent"][i]] == "gpujpeg.dec"
        assert s["start_ns"][i] == s["end_ns"][i]
        assert names[i - 1] == "gpujpeg.dec.stream"
        assert s["end_ns"][i - 1] <= s["start_ns"][i] <= s["start_ns"][i + 1]
    tables.clear_dht_tables()
    trace.clear()
    off = port.Decoder(backend="torch", device="cpu")
    off.decode_to_device(data) if to_device else off.decode(data)
    assert trace._buf is None and trace.spans().size == 0
