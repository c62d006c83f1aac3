"""The port's command line (``gpujpeg_tpu_torch.cli``) against the JAX
package's (``gpujpeg_tpu.cli``): each flow of ``tests/test_cli.py`` runs
through both on the same input files, the port with ``-D cpu``, and the
files they write must be equal byte for byte, and ``-I``/``-R`` print
the same lines."""
import os

import numpy as np
import pytest
import torch

from conftest import make_test_rgb

from gpujpeg_tpu import cli as ref_cli
from gpujpeg_tpu_torch import cli
from gpujpeg_tpu_torch.params import ImageParameters
from gpujpeg_tpu_torch.types import PixelFormat
from gpujpeg_tpu_torch.utils import image_io
from gpujpeg_tpu_torch.utils.image_io import Y4mInfo, y4m_write


def _write_ppm(path, img):
    H, W = img.shape[:2]
    image_io.save_image(str(path), img.reshape(-1), ImageParameters(
        width=W, height=H, pixel_format=PixelFormat.PF_444_U8_P012))


# Each flow takes ``run(args) -> rc`` and a directory, writes its inputs
# there (from seeds) and returns what to compare besides the files: the
# return codes and the lines printed by -I/-R.

def flow_round_trip(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(48, 64))
    return [run(["-b", "golden", str(d / "in.ppm"), str(d / "out.jpg")]),
            run(["-b", "golden", str(d / "out.jpg"), str(d / "back.ppm")])]


def flow_quality_and_subsampling(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(32, 32))
    return [run(["-b", "golden", "-q", "20", "-S", "420", str(d / "in.ppm"),
                 str(d / "lo.jpg")]),
            run(["-b", "golden", "-q", "95", str(d / "in.ppm"),
                 str(d / "hi.jpg")])]


def flow_raw_rgb_needs_size(run, d):
    (d / "in.rgb").write_bytes(bytes(16 * 16 * 3))
    return [run(["-b", "golden", str(d / "in.rgb"), str(d / "o.jpg")]),
            run(["-b", "golden", "-s", "16x16", str(d / "in.rgb"),
                 str(d / "o.jpg")])]


def flow_info_jpeg(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(32, 48))
    return [run(["-b", "golden", "-r", "4", "-g", str(d / "in.ppm"),
                 str(d / "x.jpg")]),
            "-I", run(["-I", str(d / "x.jpg")])]


def flow_component_range(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(16, 16))
    return ["-R", run(["-R", str(d / "in.ppm"), str(d / "ignored.jpg")])]


def flow_convert(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(16, 16))
    return [run(["-C", str(d / "in.ppm"), str(d / "out.rgb")])]


def flow_missing_files(run, d):
    return [run([]), run(["one.ppm"])]


def flow_y4m_video_batch(run, d):
    H, W = 32, 48
    frames = [make_test_rgb(H, W, seed=s) for s in range(3)]
    planar = [np.concatenate([f[:, :, 0].ravel(), f[:, :, 1].ravel(),
                              f[:, :, 2].ravel()]) for f in frames]
    (d / "in.y4m").write_bytes(y4m_write(Y4mInfo(width=W, height=H,
                                                 subsampling=444), planar))
    return [run(["-b", "golden", str(d / "in.y4m"),
                 str(d / "frame_%02d.jpg")])]


def flow_decode_frame_sequence(run, d):
    rcs = []
    for i in range(3):
        _write_ppm(d / f"in_{i}.ppm", make_test_rgb(32, 48, seed=i))
        rcs.append(run(["-b", "golden", str(d / f"in_{i}.ppm"),
                        str(d / ("f_%02d.jpg" % i))]))
    rcs.append(run(["-b", "golden", str(d / "f_%02d.jpg"),
                    str(d / "back_%02d.ppm")]))
    return rcs


def flow_decode_percent_in_filename(run, d):
    _write_ppm(d / "in.ppm", make_test_rgb(16, 16))
    return [run(["-b", "golden", str(d / "in.ppm"), str(d / "photo%20b.jpg")]),
            run(["-b", "golden", str(d / "photo%20b.jpg"),
                 str(d / "out%20b.ppm")])]


def flow_decode_one_based_frame_sequence(run, d):
    rcs = []
    for i in range(2):
        _write_ppm(d / f"in{i}.ppm", make_test_rgb(16, 16, seed=i))
        rcs.append(run(["-b", "golden", str(d / f"in{i}.ppm"),
                        str(d / ("g_%d.jpg" % (i + 1)))]))
    rcs.append(run(["-b", "golden", str(d / "g_%d.jpg"),
                    str(d / "h_%d.ppm")]))
    return rcs


def flow_decode_batch_needs_dst_pattern(run, d):
    rcs = []
    for i in range(2):
        _write_ppm(d / f"i{i}.ppm", make_test_rgb(16, 16, seed=i))
        rcs.append(run(["-b", "golden", str(d / f"i{i}.ppm"),
                        str(d / ("j_%d.jpg" % i))]))
    rcs.append(run(["-b", "golden", str(d / "j_%d.jpg"),
                    str(d / "single.ppm")]))
    return rcs


FLOWS = [flow_round_trip, flow_quality_and_subsampling,
         flow_raw_rgb_needs_size, flow_info_jpeg, flow_component_range,
         flow_convert, flow_missing_files, flow_y4m_video_batch,
         flow_decode_frame_sequence, flow_decode_percent_in_filename,
         flow_decode_one_based_frame_sequence,
         flow_decode_batch_needs_dst_pattern]


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _run_both(flow, tmp_path, capsys, port_args=("-D", "cpu")):
    """Run ``flow`` through the port's CLI and the JAX package's, each in
    a directory of its own; return (port, reference) results and files,
    with the lines -I/-R printed after each "-I"/"-R" marker."""
    out = []
    for name, main, extra in (("port", cli.main, list(port_args)),
                              ("ref", ref_cli.main, [])):
        d = tmp_path / name
        d.mkdir()
        capsys.readouterr()

        def run(args, main=main, extra=extra):
            rc = main(args + extra if args and args[0] not in ("-I", "-R")
                      else args)
            return rc, capsys.readouterr().out

        res = flow(run, d)
        # -I/-R print lines to compare; other flows print timings
        marks = [r for i, r in enumerate(res)
                 if i and res[i - 1] in ("-I", "-R")]
        rcs = [r[0] for r in res if isinstance(r, tuple)]
        out.append((rcs, [m[1] for m in marks], _files(d)))
    return out


@pytest.mark.parametrize("flow", FLOWS, ids=[f.__name__[5:] for f in FLOWS])
def test_flow_writes_the_reference_files(flow, tmp_path, capsys):
    (rcs, printed, files), (ref_rcs, ref_printed, ref_files) = _run_both(
        flow, tmp_path, capsys)
    assert rcs == ref_rcs
    assert printed == ref_printed
    assert files.keys() == ref_files.keys()
    for name in files:
        assert files[name] == ref_files[name], name


def test_default_backends_write_the_reference_files(tmp_path, capsys):
    """Without ``-b``: the port's torch backend on the CPU (its kernels'
    plain versions) against the JAX backend, encode and decode, with the
    suggested restart interval."""
    def flow(run, d):
        _write_ppm(d / "in.ppm", make_test_rgb(64, 80))
        return [run([str(d / "in.ppm"), str(d / "out.jpg")]),
                run(["-q", "90", "-S", "420", str(d / "in.ppm"),
                     str(d / "sub.jpg")]),
                run([str(d / "out.jpg"), str(d / "back.ppm")])]

    (rcs, _, files), (ref_rcs, _, ref_files) = _run_both(flow, tmp_path,
                                                        capsys)
    assert rcs == ref_rcs == [0, 0, 0]
    assert files == ref_files


def test_device_list_and_selection(capsys):
    """-L lists the CUDA devices (none here: exit 1); -D takes an index
    or cpu and nothing else."""
    if torch.cuda.is_available():
        assert cli.main(["-L"]) == 0
        assert torch.cuda.get_device_name(0) in capsys.readouterr().out
    else:
        assert cli.main(["-L"]) == 1
    assert cli.build_parser().parse_args(["-D", "cpu"]).device == \
        torch.device("cpu")
    assert cli.build_parser().parse_args(["-D", "1"]).device == \
        torch.device("cuda", 1)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["-D", "tpu"])


def test_torch_backend_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_ppm(tmp_path / "in.ppm", make_test_rgb(16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path / "in.ppm"), str(tmp_path / "out.jpg")])
    assert not os.path.exists(tmp_path / "out.jpg")
