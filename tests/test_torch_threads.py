"""Concurrent first calls and where the port builds: the kernel library
from several threads at once into one build dir (a stand-in ``nvcc``
that takes a random time and fails a link whose objects are missing),
the native host codec's first load from several threads, independent
coders in threads (the counterpart of ``tests/test_robustness.py``'s
``test_concurrent_encoders``, after GPUJPEG's ``mt_encode.c``), and the
kernel build dir of a package the user cannot write."""
import concurrent.futures
import os
import shutil
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from conftest import make_test_rgb

import gpujpeg_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a stand-in nvcc: each step sleeps 0.1-0.9 s; a link fails unless every
#: object it is given exists
_RACING_NVCC = '''#!{python}
import os, random, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
time.sleep(random.uniform(0.1, 0.9))
if "-shared" in args:
    missing = [a for a in args if a.endswith(".o") and not os.path.exists(a)]
    if missing:
        sys.exit("link: missing " + " ".join(missing))
open(out, "w").close()
'''


def _racing_nvcc(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text(_RACING_NVCC.format(python=sys.executable))
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    build = tmp_path / "build"
    monkeypatch.setenv("GPUJPEG_TPU_TORCH_BUILD_DIR", str(build))
    return build


def _in_threads(fn, n: int) -> list:
    """``fn()`` in ``n`` threads started together; their results."""
    barrier = threading.Barrier(n)

    def run():
        barrier.wait(timeout=30)
        return fn()
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(run) for _ in range(n)]
        return [f.result(timeout=120) for f in futs]


def test_library_path_from_threads_builds_once(tmp_path, monkeypatch):
    """Four threads that call ``_build.library_path()`` at once on an empty
    build dir all get the one library, and the dir holds only it."""
    from gpujpeg_tpu_torch import _build
    build = _racing_nvcc(tmp_path, monkeypatch)
    paths = _in_threads(_build.library_path, 4)
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert sorted(p.name for p in build.iterdir()) == [
        os.path.basename(paths[0])]


def test_load_kernels_from_threads_loads_once(tmp_path, monkeypatch):
    """Four threads' first ``load_kernels()`` build and load the library
    once and share the loaded object; a later call takes no lock."""
    from gpujpeg_tpu_torch import _build
    _racing_nvcc(tmp_path, monkeypatch)
    loads = []

    class _Lib:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.2)
            for name in _build.SIGNATURES:
                setattr(self, name, type("Entry", (), {})())
    monkeypatch.setattr(_build, "_KERNELS", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", _Lib)
    libs = _in_threads(_build.load_kernels, 4)
    assert len(loads) == 1 and all(lib is libs[0] for lib in libs)
    with _build._LOCK:      # held: a loaded library needs no lock
        assert _build.load_kernels() is libs[0]


def test_native_lib_from_threads_waits_for_the_build(monkeypatch):
    """Every thread of a concurrent first ``native.lib()`` gets the
    library: one that arrives during the build waits for it."""
    from gpujpeg_tpu_torch import native
    so = native._build()
    if so is None:
        pytest.skip("no C++ compiler for the native host codec")
    builds = []

    def slow_build():
        builds.append(1)
        time.sleep(0.3)
        return so
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_build", slow_build)
    libs = _in_threads(native.lib, 4)
    assert len(builds) == 1
    assert libs[0] is not None and all(lib is libs[0] for lib in libs)


def test_concurrent_encoders():
    """Independent torch coders on the CPU in four threads, eight frames:
    each thread's stream and decode equal the serial calls' (reference:
    ``tests/test_robustness.py::test_concurrent_encoders``)."""
    H, W = 32, 48
    imgs = [make_test_rgb(H, W, seed=s) for s in range(8)]
    image = port.ImageParameters(width=W, height=H,
                                 color_space=port.ColorSpace.RGB,
                                 pixel_format=port.PixelFormat.PF_444_U8_P012)
    params = port.Parameters(quality=80, restart_interval=2)

    def work(i):
        enc = port.Encoder(backend="torch", device="cpu")
        data = enc.encode(imgs[i].reshape(-1), params, image)
        raw, _ = port.Decoder(backend="torch", device="cpu").decode(data)
        return data, raw

    serial = [work(i) for i in range(8)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        threaded = list(ex.map(work, range(8)))
    for (d_s, r_s), (d_t, r_t) in zip(serial, threaded):
        assert d_t == d_s
        np.testing.assert_array_equal(r_t, r_s)


def test_kernel_build_dir_outside_a_read_only_package(tmp_path):
    """A copy of the package made read-only, imported in a fresh process
    with ``XDG_CACHE_HOME`` in a tmp dir: ``kernel_build_dir()`` is
    ``kernels`` in the per-user cache (0700) and nothing is created in
    the package. (The tests may run as root, which ignores file modes, so
    the listing is checked, not a ``PermissionError``.)"""
    pkg = tmp_path / "site" / "gpujpeg_tpu_torch"
    shutil.copytree(os.path.join(REPO, "gpujpeg_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))

    def listing():
        return sorted(os.path.relpath(os.path.join(d, f), pkg)
                      for d, dirs, files in os.walk(pkg)
                      for f in files + dirs)
    before = listing()
    for d, dirs, files in os.walk(pkg):
        for f in files + dirs:
            p = os.path.join(d, f)
            os.chmod(p, os.stat(p).st_mode & ~0o222)
    os.chmod(pkg, 0o555)
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "GPUJPEG_TPU_TORCH_BUILD_DIR")}
    env.update(PYTHONPATH=str(pkg.parent), XDG_CACHE_HOME=str(cache),
               PYTHONDONTWRITEBYTECODE="1")
    code = ("import gpujpeg_tpu_torch.runtime as r; "
            "print(r.__file__); print(r.kernel_build_dir())")
    try:
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        mod_file, build_dir = out.stdout.split()
        assert mod_file.startswith(str(pkg))
        assert build_dir == str(cache / "gpujpeg_tpu_torch" / "kernels")
        assert stat.S_IMODE(os.stat(build_dir).st_mode) == 0o700
        assert listing() == before
    finally:
        for d, dirs, files in os.walk(tmp_path):
            for f in [d] + [os.path.join(d, x) for x in dirs]:
                os.chmod(f, os.stat(f).st_mode | 0o700)
