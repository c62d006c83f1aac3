"""8K stills at Q100 and restart interval 64 (the benchmark's configuration
``still_8k_rgb444_q100_rst64``), cut to 272x256 on the CPU: 51 segments of
64 blocks, past ``CPU_SEGMENT_THRESHOLD``, so both coders take the device
route (the kernels' plain versions here).

At this quality the bench frames' segments hold about 2.1 KB, so D1 reads
rows past 384 words (the JAX reference's K5 regime); E2 sizes every
block's bit string at 224 B, the widest a block can need, and E3 every
segment's row at twice that a block. The port's streams pass
the benchmark's judge against its plain reference (``portbench``), and so
do its frames decoded from the reference's streams, within the
configuration's limits; D1 runs on rows wider than 384 words, every
segment wraps D0's 256-byte ring, and at the full size the stream spans
several of the compaction's 16 MiB chunks (the 8K Q75 cells reach
neither: segments of 149 B at most, 4.3 MB streams); the encode's
span ``gpujpeg.enc.copy_back`` lies inside ``gpujpeg.enc.memory_from``, one
a compacted chunk, and its bytes sum to the compacted stream's."""
import json
import os

import numpy as np
import pytest

from gpujpeg_tpu_torch import trace
from gpujpeg_tpu_torch.models.decoder import (CPU_SEGMENT_THRESHOLD,
                                              plan_from_info)
from gpujpeg_tpu_torch.ops import decode as D
from gpujpeg_tpu_torch.ops import entropy, huffman_encode, pipeline
from gpujpeg_tpu_torch.plan import make_plan
from gpujpeg_tpu_torch.stream.reader import read_image
from portbench import frames, judge
from portbench.program import Program
from portbench.reference.geometry import make_geometry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "still_8k_rgb444_q100_rst64"
#: the cut: 34 x 32 blocks a component, 3 components, 51 segments of 64
WIDTH, HEIGHT = 272, 256
SEED = 2 ** 33 + 26
#: the JAX reference's K4 row limit, in words; K5 decodes wider rows
K4_WORDS = 384
#: E2's bytes a block (``entropy.BLOCK_CAP_BYTES``), the widest a block's
#: string can need
WIDEST_BLOCK_BYTES = 224
#: D0's ring of destuffed bytes a segment (``csrc/destuff_rows.cu``
#: ``kRing``): the 8K Q75 segments (149 B at most) never wrap it
D0_RING_BYTES = 256
#: the configuration's full frame, in pixels
FULL_PIXELS = 7680 * 4320


def _config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           CONFIG + ".json")) as f:
        cfg = json.load(f)
    return {**cfg, "width": WIDTH, "height": HEIGHT, "pool_frames": 2}


@pytest.fixture(scope="module")
def cell():
    """(configuration, deployment, program, frames): the program on the CPU
    with perf stats on."""
    cfg = _config()
    geo = make_geometry(cfg["width"], cfg["height"], cfg["sampling"],
                        cfg["interleaved"], cfg["restart_interval"],
                        cfg["color_space_internal"] == "RGB")
    prog = Program(cfg, {"output": "host"}, "cpu", True)
    pool = frames.make_pool(cfg, SEED, "cpu")
    return cfg, judge.Deployment(cfg, geo), prog, pool


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def test_size_reaches_the_regime(cell):
    cfg, dep, prog, _ = cell
    plan = make_plan(prog.params, prog.image)
    assert plan.n_segments == 51 >= CPU_SEGMENT_THRESHOLD
    assert int(plan.max_seg_block_count) == cfg["restart_interval"] == 64
    # E2's string a block and E3's row a segment, as the device path
    # sizes them (at every quality)
    assert entropy.BLOCK_CAP_BYTES == WIDEST_BLOCK_BYTES
    assert entropy.build_seg_geometry(plan, "cpu").cap_out \
        == entropy.segment_out_capacity(64) >= 2 * 64 * WIDEST_BLOCK_BYTES
    assert not prog.decoder._golden_route(plan)


def test_streams_and_frames_within_the_limits(cell, monkeypatch):
    """The port's streams judged against the reference's float64
    quotients, its decode of the reference's streams against the
    reference's float64 samples; D1 (through D0's rows) on rows past 384
    words, once a decode."""
    cfg, dep, prog, pool = cell
    widths = []
    real = pipeline.huffman_decode

    def watching(rows, *a):
        widths.append(rows.shape[1])
        return real(rows, *a)

    monkeypatch.setattr(pipeline, "huffman_decode", watching)
    frames_of = dict(enumerate(pool))
    streams = [(i, prog.encode(f.numpy())) for i, f in enumerate(pool)]
    enc = judge.worst_miss(dep, streams, frames_of, "cpu")
    assert enc <= cfg["limits"]["enc_worst_miss"]
    refs = [dep.stream(f) for f in pool]
    outs = [(i, prog.decode(s)) for i, s in enumerate(refs)]
    dec = judge.decode_miss(dep, outs, frames_of, "cpu")
    assert dec <= cfg["limits"]["dec_worst_miss"]
    assert len(widths) == len(refs) and min(widths) > K4_WORDS
    for _, s in streams + list(enumerate(refs)):
        plan, sd, segs = plan_from_info(read_image(s))
        x = D.scan_bytes(plan, sd, segs)
        assert x.wcap > K4_WORDS
        # 12 bits a pixel and more: each segment 1.5 KB or more on average
        assert x.n_data > 1.5 * WIDTH * HEIGHT
        # every segment wraps D0's ring, and the full frame's stream at
        # this rate spans several of the compaction's chunks
        lo, hi = x.ranges
        assert (hi - lo).min() > 2 * D0_RING_BYTES
        full = x.n_data * FULL_PIXELS / (WIDTH * HEIGHT)
        assert full > 3 * huffman_encode.COMPACT_CHUNK_BYTES


def test_copy_back_spans_inside_the_compaction(cell, monkeypatch):
    """Chunks of 16 KB: a copy back span a chunk, each inside the call's
    ``gpujpeg.enc.memory_from``, their bytes summing to the compacted
    stream's (the scans' entropy-coded bytes, markers included)."""
    cfg, dep, prog, pool = cell
    monkeypatch.setattr(huffman_encode, "COMPACT_CHUNK_BYTES", 1 << 14)
    data = prog.encode(pool[0].numpy())
    s = trace.spans()
    names = np.asarray(trace.NAMES, dtype=object)[s["name"]]
    (mf,) = np.flatnonzero(names == "gpujpeg.enc.memory_from")
    copies = np.flatnonzero(names == "gpujpeg.enc.copy_back")
    scans = sum(sc.data.size for sc in read_image(data).scans)
    assert len(copies) >= scans // (1 << 14)
    assert len(copies) > 1
    assert (s["parent"][copies] == mf).all()
    assert (s["start_ns"][copies] >= s["start_ns"][mf]).all()
    assert (s["end_ns"][copies] <= s["end_ns"][mf]).all()
    assert (s["start_ns"][copies[1:]] >= s["end_ns"][copies[:-1]]).all()
    assert int(s["bytes"][copies].sum()) == int(s["bytes"][mf]) == scans
    # the chunks leave the stream as it was
    monkeypatch.setattr(huffman_encode, "COMPACT_CHUNK_BYTES", 1 << 24)
    assert prog.encode(pool[0].numpy()) == data
