"""The port's host layer against the JAX package: import hygiene, golden
encode bytes and golden decode pixels (gpujpeg_tpu_torch vs gpujpeg_tpu)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(mod, w, h, q, ri, interleaved=False):
    image = mod.ImageParameters(width=w, height=h,
                                color_space=mod.ColorSpace.RGB,
                                pixel_format=mod.PixelFormat.PF_444_U8_P012)
    return mod.Parameters(quality=q, restart_interval=ri,
                          interleaved=interleaved), image


def test_port_imports_without_jax():
    """Every module of the package, found by walking it (so no new module
    escapes the check), imports in a fresh process without loading JAX
    or the JAX package."""
    code = ("import importlib, pkgutil, sys, gpujpeg_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "p.__path__, 'gpujpeg_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'gpujpeg_tpu')]; "
            "assert not bad, bad; print('clean', *sorted(mods))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]
    mods = set(r.stdout.split()[1:])
    for name in ("cli", "__main__", "utils.image_io", "tools.reformat",
                 "tools.perf_e12", "tools.perf_pixels", "tools.soak",
                 "tools.checks",
                 "examples.video_pipeline", "parallel.sharded",
                 "parallel.multihost", "examples.sharded_encode",
                 "examples.multihost_video"):
        assert f"gpujpeg_tpu_torch.{name}" in mods, name


def test_package_data_carries_every_kernel_include():
    """A non-editable install ships what ``pyproject.toml``'s package
    data lists: every ``#include "..."`` of the kernels' sources must
    match one of its globs, or the first nvcc build fails."""
    import fnmatch
    import glob
    import re
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["gpujpeg_tpu_torch"]
    pkg = os.path.join(REPO, "gpujpeg_tpu_torch")
    sources = sorted(glob.glob(os.path.join(pkg, "csrc", "*.cu")))
    assert sources
    needed = set()
    for src in sources:
        needed.add(os.path.relpath(src, pkg))
        with open(src) as f:
            for inc in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(),
                                  re.M):
                path = os.path.join(os.path.dirname(src), inc)
                assert os.path.exists(path), (src, inc)
                needed.add(os.path.relpath(path, pkg))
    assert any(n.endswith(".cuh") for n in needed)
    missing = [n for n in sorted(needed)
               if not any(fnmatch.fnmatch(n, g) for g in globs)]
    assert not missing, missing


def test_pyproject_installs_the_port_with_torch():
    """``pip install .[torch]`` pulls what the port imports (torch and
    numpy) without changing the JAX package's base dependencies, and the
    port's two commands are installed."""
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    assert project["dependencies"] == ["jax", "numpy"]
    assert sorted(project["optional-dependencies"]["torch"]) == [
        "numpy", "torch"]
    scripts = project["scripts"]
    assert scripts["gpujpegtool-torch"] == "gpujpeg_tpu_torch.cli:main"
    assert scripts["gpujpeg-reformat-torch"] == (
        "gpujpeg_tpu_torch.tools.reformat:main")
    for target in (scripts["gpujpegtool-torch"],
                   scripts["gpujpeg-reformat-torch"]):
        mod, fn = target.split(":")
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        with open(path) as f:
            assert f"def {fn}(" in f.read(), target


@pytest.mark.parametrize("ri", [0, 2, 32])
@pytest.mark.parametrize("q", [75, 90])
@pytest.mark.parametrize("h,w", [(64, 80), (17, 13), (256, 256)])
def test_golden_bytes_and_pixels_match_reference(h, w, q, ri):
    img = make_test_rgb(h, w)
    pp, pi = _params(port, w, h, q, ri)
    rp, ri_ = _params(ref, w, h, q, ri)
    data = port.Encoder(backend="golden").encode(img.reshape(-1), pp, pi)
    expect = ref.Encoder(backend="golden").encode(img.reshape(-1), rp, ri_)
    assert data == expect
    raw, info = port.Decoder(backend="golden").decode(data)
    raw_ref, info_ref = ref.Decoder(backend="golden").decode(expect)
    assert (info.width, info.height) == (info_ref.width, info_ref.height)
    np.testing.assert_array_equal(raw, raw_ref)


def test_golden_decode_interleaved_and_grayscale_output():
    img = make_test_rgb(48, 64)
    pp, pi = _params(port, 64, 48, 85, 3, interleaved=True)
    rp, ri_ = _params(ref, 64, 48, 85, 3, interleaved=True)
    data = ref.Encoder(backend="golden").encode(img.reshape(-1), rp, ri_)
    assert port.Encoder(backend="golden").encode(img.reshape(-1), pp,
                                                 pi) == data
    # PixelFormat.U8 == 0 is falsy: the requested grayscale output must
    # still be honoured
    dec, dec_ref = port.Decoder(backend="golden"), ref.Decoder(backend="golden")
    dec.set_output_format(port.YCBCR_JPEG, port.PixelFormat.U8)
    dec_ref.set_output_format(ref.YCBCR_JPEG, ref.PixelFormat.U8)
    raw, info = dec.decode(data)
    raw_ref, _ = dec_ref.decode(data)
    assert info.pixel_format == port.PixelFormat.U8
    assert raw.size == 48 * 64
    np.testing.assert_array_equal(raw, raw_ref)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Encoder(backend="torch", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Decoder(backend="torch", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Decoder()


def test_unknown_backends_raise():
    with pytest.raises(ValueError):
        port.Encoder(backend="jax")
    with pytest.raises(ValueError):
        port.Decoder(backend="jax")


_FAKE_NVCC = '''#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_DIR"]
if "-c" in args:
    src = os.path.basename(args[-1])
    open(os.path.join(log, "started-" + src), "w").close()
    t0 = time.time()
    while sum(f.startswith("started-") for f in os.listdir(log)) \\
            < int(os.environ["FAKE_NVCC_N"]):
        if time.time() - t0 > 60:
            sys.exit("the compiles did not run together")
        time.sleep(0.01)
    if src == os.environ.get("FAKE_NVCC_FAIL"):
        sys.exit("error in " + src)
else:
    with open(os.path.join(log, "link"), "w") as f:
        f.write(" ".join(args))
open(out, "w").close()
'''


def test_kernel_build_runs_one_nvcc_per_source_together(tmp_path,
                                                         monkeypatch):
    """The kernel library builds with one ``nvcc -c`` per ``csrc`` source,
    all running at once (each stand-in compile waits for all the others
    to start), then one link; a failing source is named and leaves no
    library."""
    from gpujpeg_tpu_torch import _build
    n = len(_build._sources())
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC.format(python=sys.executable))
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setenv("FAKE_NVCC_N", str(n))
    for case in ("ok", "fail"):
        log = tmp_path / f"log-{case}"
        log.mkdir()
        build = tmp_path / f"build-{case}"
        monkeypatch.setenv("FAKE_NVCC_DIR", str(log))
        monkeypatch.setenv("GPUJPEG_TPU_TORCH_BUILD_DIR", str(build))
        if case == "ok":
            so = _build.library_path()
            assert os.path.exists(so)
            link = (log / "link").read_text().split()
            assert "-shared" in link and "sm_90a" in " ".join(link)
            assert sum(a.endswith(".o") for a in link) == n
        else:
            monkeypatch.setenv("FAKE_NVCC_FAIL", "postprocess.cu")
            with pytest.raises(RuntimeError, match="postprocess.cu"):
                _build.library_path()
        assert len(list(log.glob("started-*.cu"))) == n
        assert sorted(p.name for p in build.iterdir()) == (
            [os.path.basename(so)] if case == "ok" else [])


def test_every_launch_goes_through_the_device_guard():
    """No kernel entry is called with a stream outside ``_build.launch``:
    the package's and ``chip_smoke.py``'s sources name no ``check_launch(``
    and no ``cuda_stream`` anywhere but ``_build.py``."""
    import glob
    pkg = os.path.join(REPO, "gpujpeg_tpu_torch")
    files = sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    launches = []
    for path in files:
        with open(path) as f:
            text = f.read()
        if os.path.basename(path) == "_build.py":
            assert "torch.cuda.device(device)" in text
            continue
        assert "check_launch(" not in text, path
        assert "cuda_stream" not in text, path
        launches.append(text.count("_build.launch(")
                        + text.count("_build.query("))
    # the wrappers' 10 launches, the tools' 4 and their grid query, and
    # chip_smoke's edge copies
    assert sum(launches) >= 16


class _Guard:
    """Stand-in for ``torch.cuda.device``: logs entering and leaving."""
    log: list = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        self.log.append(("enter", self.device))

    def __exit__(self, *exc):
        self.log.append(("exit", self.device))


class _Stream:
    def __init__(self, device):
        self.cuda_stream = 0x5000 + torch.device(device).index


class _Lib:
    """Stand-in kernel library: each entry logs its arguments and the
    guard's state, and returns ``err``."""
    err = 0

    def gj_fake(self, *args):
        _Guard.log.append(("call", args))
        return self.err


def test_launch_enters_the_tensors_device_and_checks(monkeypatch):
    """``_build.launch`` makes the operands' card current around the entry
    (so ``cudaGetDevice`` and ``cudaFuncSetAttribute`` act on it), passes
    that card's current stream last, leaves the guard on an error and
    raises on a non-zero return; ``query`` passes no stream."""
    from gpujpeg_tpu_torch import _build
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(_Guard, "log", [])
    lib = _Lib()
    dev = torch.device("cuda", 1)
    _build.launch("gj_fake", dev, 7, 8, lib=lib)
    assert _Guard.log == [("enter", dev), ("call", (7, 8, 0x5001)),
                          ("exit", dev)]
    lib.err = 700
    with pytest.raises(RuntimeError, match="gj_fake: CUDA launch failed "
                                           "with error 700"):
        _build.launch("gj_fake", "cuda:3", 9, lib=lib)
    assert _Guard.log[3:] == [("enter", torch.device("cuda", 3)),
                              ("call", (9, 0x5003)),
                              ("exit", torch.device("cuda", 3))]
    with pytest.raises(RuntimeError, match="error 700"):
        _build.query("gj_fake", 5, lib=lib)
    assert _Guard.log[-1] == ("call", (5,))
