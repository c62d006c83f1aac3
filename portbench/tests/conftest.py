"""Fixtures of the benchmark's CPU tests: a copy of the benchmark cut to
small frames, and the ``card`` marker for tests that need a CUDA card
(they decide inside the ``card`` fixture and skip here)."""
import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: sizes of the small copy: (height, width) a configuration
SMALL = {"still_8k_rgb444_q75": (136, 200), "video_hd_i420_q75": (72, 96)}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def copy_bench(dst: str, sizes: dict | None = None) -> str:
    """``BENCHMARK.json`` and ``portbench/`` copied to ``dst``, each
    configuration of ``sizes`` cut to (height, width) and a pool of at
    most 4 frames."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for name, (h, w) in (sizes or {}).items():
        p = os.path.join(dst, "portbench", "configs", name + ".json")
        with open(p) as f:
            c = json.load(f)
        c["height"], c["width"] = h, w
        c["pool_frames"] = min(c["pool_frames"], 4)
        with open(p, "w") as f:
            json.dump(c, f)
    return dst


@pytest.fixture
def small_root(tmp_path):
    return copy_bench(str(tmp_path), SMALL)
