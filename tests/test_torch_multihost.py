"""The port's multi-process coders (``gpujpeg_tpu_torch.parallel.
multihost``) on the CPU: two ranks spawned as subprocesses, joined over
gloo at ``tcp://localhost:<free port>``, four ``cpu`` entries a rank (the
counterpart of ``tests/test_multihost.py``'s two JAX processes of four
virtual devices). Every stream equals the JAX ``Encoder(backend="jax")``
stream and the port's ``Encoder(device="cpu")`` stream of the same
frame; decodes equal the port's ``Decoder`` bit for bit."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
from gpujpeg_tpu_torch.parallel import (Mesh, MultiHostDecoder,
                                        MultiHostEncoder,
                                        MultiHostSingleImageEncoder,
                                        global_mesh, init_distributed)
from gpujpeg_tpu_torch.parallel.multihost import host_group

H, W = 128, 160

_WORKER = r"""
import os, sys
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.environ["GPUJPEG_TPU_REPO"])
import numpy as np
import torch
import torch.distributed as dist
import gpujpeg_tpu_torch as gj
from gpujpeg_tpu_torch.parallel import (
    Mesh, MultiHostDecoder, MultiHostEncoder, MultiHostSingleImageEncoder,
    global_mesh, init_distributed)

torch.set_num_threads(2)
init_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
init_distributed(f"localhost:{port}", num_processes=2, process_id=pid)  # no-op
assert dist.get_world_size() == 2 and dist.get_rank() == pid
image = gj.ImageParameters(width=160, height=128,
                           color_space=gj.ColorSpace.RGB,
                           pixel_format=gj.PixelFormat.PF_444_U8_P012)
params = gj.Parameters(quality=80, restart_interval=4)
load = lambda name: np.load(os.path.join(outdir, name))
save = lambda name, data: open(os.path.join(outdir, name), "wb").write(data)
local = ["cpu"] * 4

# frames a rank (video sharding): rank p owns frame p and noisy frame p
enc = MultiHostEncoder(global_mesh(local_devices=local))
assert enc.mesh.shape == {"frame": 2, "seg": 4}
streams = enc.encode_my_frames([load(f"frame{pid}.npy"),
                                load(f"noisy{pid}.npy")], params, image)
save(f"frame_p{pid}.jpg", streams[0])
save(f"noisy_p{pid}.jpg", streams[1])

# one image's 8 bands over both ranks
single = MultiHostSingleImageEncoder(Mesh([local]))
save(f"single_p{pid}.jpg", single.encode(load("single.npy"), params, image))

# each rank decodes its own streams
for i, (raw, oi) in enumerate(
        MultiHostDecoder(Mesh([local])).decode_my_frames(streams)):
    np.save(os.path.join(outdir, f"raw{i}_p{pid}.npy"), raw)
dist.destroy_process_group()
print("WORKER_OK", pid)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _noisy(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


def _setup(mod, h=H, w=W, q=80, ri=4):
    return (mod.Parameters(quality=q, restart_interval=ri),
            mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012))


def _want(img, **kw) -> bytes:
    """The JAX stream of ``img``, checked equal to the port's own."""
    want = ref.Encoder(backend="jax").encode(img, *_setup(ref, **kw))
    assert port.Encoder(device="cpu").encode(img, *_setup(port, **kw)) \
        == want
    return want


def test_two_process_distributed_encode_and_decode(tmp_path, monkeypatch):
    frames = {f"frame{p}.npy": make_test_rgb(H, W, seed=10 + p)
              for p in range(2)}
    frames.update({f"noisy{p}.npy": _noisy(100 + p) for p in range(2)})
    frames["single.npy"] = make_test_rgb(H, W, seed=42)
    for name, a in frames.items():
        np.save(tmp_path / name, a)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["GPUJPEG_TPU_REPO"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    port_no = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), port_no, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
        assert "WORKER_OK" in o, o[-3000:]

    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    dec = port.Decoder(device="cpu")
    for pid in range(2):
        for i, name in enumerate(("frame", "noisy")):
            got = (tmp_path / f"{name}_p{pid}.jpg").read_bytes()
            assert got == _want(frames[f"{name}{pid}.npy"]), (name, pid)
            np.testing.assert_array_equal(
                np.load(tmp_path / f"raw{i}_p{pid}.npy"), dec.decode(got)[0])
    a = (tmp_path / "single_p0.jpg").read_bytes()
    b = (tmp_path / "single_p1.jpg").read_bytes()
    assert a == b
    assert a == _want(frames["single.npy"])


@pytest.fixture
def one_rank():
    """A process group of this process alone, over gloo."""
    init_distributed(f"localhost:{_free_port()}", num_processes=1,
                     process_id=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_single_rank_noisy_frame(one_rank):
    """The counterpart of the JAX package's single-process tier-2 test: a
    noisy 64x64 Q90 frame through both multi-process encoders with a
    world of one (the gathers over gloo run), equal to the JAX stream;
    the port has no tiers to engage."""
    noisy = _noisy(7, 64, 64)
    want = _want(noisy, h=64, w=64, q=90, ri=2)
    params, image = _setup(port, 64, 64, q=90, ri=2)
    enc = MultiHostEncoder(global_mesh(local_devices=["cpu"] * 8))
    assert enc.mesh.shape == {"frame": 1, "seg": 8}
    assert enc.encode_my_frames([noisy], params, image) == [want]
    single = MultiHostSingleImageEncoder(Mesh([["cpu"] * 8]))
    assert single.encode(noisy, params, image) == want


def test_host_bytes_go_over_gloo(one_rank, monkeypatch):
    """The gathers run on the default group where it has gloo (as
    init_distributed makes it), else on a new gloo group of its ranks."""
    assert host_group() is None
    made = []
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(dist, "new_group",
                        lambda **kw: made.append(kw) or "gloo group")
    assert host_group() == "gloo group"
    assert made == [{"backend": "gloo"}]


def test_multihost_decoder_local_frames(monkeypatch):
    """Without a process group: each stream's bands over a 4-entry local
    mesh, equal to the port's Decoder bit for bit."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    params, image = _setup(port)
    enc = port.Encoder(device="cpu")
    streams = [enc.encode(make_test_rgb(H, W, seed=20 + i), params, image)
               for i in range(2)]
    got = MultiHostDecoder(Mesh([["cpu"] * 4])).decode_my_frames(streams)
    assert len(got) == 2
    dec = port.Decoder(device="cpu")
    for stream, (raw, _) in zip(streams, got):
        np.testing.assert_array_equal(raw, dec.decode(stream)[0])
