"""The command's exits: without a card it fails and prints no result;
in a directory that holds only the benchmark's files it fails too."""
import os
import shutil
import subprocess
import sys

from conftest import ROOT, copy_bench


def run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "still8k.host",
         "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result(tmp_path):
    root = copy_bench(str(tmp_path))
    os.symlink(os.path.join(ROOT, "gpujpeg_tpu_torch"),
               os.path.join(root, "gpujpeg_tpu_torch"))
    r = run_cli(root)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_benchmark_alone_fails(tmp_path):
    root = copy_bench(str(tmp_path))
    assert sorted(os.listdir(root)) == ["BENCHMARK.json", "portbench"]
    r = run_cli(root)
    assert r.returncode != 0 and r.stdout.strip() == ""
    shutil.rmtree(os.path.join(root, "portbench", ".cache"),
                  ignore_errors=True)
