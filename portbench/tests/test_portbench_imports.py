"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names
compared whole (the port's name begins with the JAX package's)."""
import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "gpujpeg_tpu"}


def imports(path: str) -> set:
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay in the benchmark's folder)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub: str = "") -> list:
    return sorted(os.path.join(d, f)
                  for d, _, fs in os.walk(os.path.join(HERE, sub))
                  for f in fs if f.endswith(".py"))


def test_imports_are_read_whole(tmp_path):
    path = tmp_path / "probe_imports.py"
    path.write_text("import gpujpeg_tpu_torch.models\nfrom jax import numpy\n"
                    "from . import x\nimport numpy as np, gpujpeg_tpu.ops\n")
    assert imports(str(path)) == {"gpujpeg_tpu_torch", "jax", "numpy",
                                  "gpujpeg_tpu"}


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_jax(path):
    assert not imports(path) & NEVER


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_stands_alone(path):
    assert not imports(path) & (NEVER | {"gpujpeg_tpu_torch", "portbench"})


def test_forbidden_modules_whole_names(monkeypatch):
    from portbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "gpujpeg_tpu_torch_probe", sys)
    assert "gpujpeg_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpujpeg_tpu.probe", sys)
    assert "gpujpeg_tpu" in forbidden_modules()
