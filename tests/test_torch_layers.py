"""The port's layering, read from its source (no card, nothing run).

``ops/pipeline.py`` is the one seam that runs a frame's device steps for
every coder (``models/``, ``parallel/``): the layers below the coders
import none of them and take none of them as an argument, and nothing
outside the pipeline reaches for its private names. Each rule is its own
case.
"""
from __future__ import annotations

import ast
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gpujpeg_tpu_torch")
PIPELINE = os.path.join(PKG, "ops", "pipeline.py")
CODERS = {"Encoder", "Decoder", "ShardedEncoder", "ShardedDecoder",
          "MultiHostEncoder", "MultiHostSingleImageEncoder",
          "MultiHostDecoder"}
#: what a coder object carries and a layer below it would read
CODER_ATTRS = {"stats", "capture_device_call", "last_device_call",
               "output_to_device", "_contexts"}


def _files(*parts):
    top = os.path.join(PKG, *parts)
    if top.endswith(".py"):
        return [top]
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(top)
                  for f in fs if f.endswith(".py"))


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _module(path):
    rel = os.path.relpath(path, ROOT)[:-len(".py")].split(os.sep)
    return rel[:-1] if rel[-1] == "__init__" else rel


def _imports(path):
    """Every module ``path`` imports, absolute, as a list of its parts."""
    out = []
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            out += [a.name.split(".") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out += [_resolve(path, node) + [a.name] for a in node.names]
    return out


def _lower_layers_import_no_coder():
    bad = []
    for path in (_files("ops") + _files("stream") + _files("tables.py")
                 + _files("plan.py")):
        for mod in _imports(path):
            if mod[:2] in (["gpujpeg_tpu_torch", "models"],
                           ["gpujpeg_tpu_torch", "parallel"]):
                bad.append(f"{os.path.relpath(path, ROOT)} imports "
                           f"{'.'.join(mod)}")
    return bad


def _ops_take_no_coder():
    bad = []
    for path in _files("ops"):
        rel = os.path.relpath(path, ROOT)
        for node in ast.walk(_tree(path)):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                names = [x.arg for x in a.posonlyargs + a.args
                         + a.kwonlyargs]
                bad += [f"{rel}: {node.name}({n})" for n in names
                        if n in ("encoder", "decoder")]
            elif isinstance(node, ast.Name) and node.id in CODERS:
                bad.append(f"{rel}:{node.lineno}: {node.id}")
            elif isinstance(node, ast.Attribute) and (
                    node.attr in CODERS or node.attr in CODER_ATTRS):
                bad.append(f"{rel}:{node.lineno}: .{node.attr}")
    return bad


def _no_private_pipeline_names_outside_it():
    bad = []
    for path in _files() + [os.path.join(ROOT, "chip_smoke.py")]:
        if path == PIPELINE:
            continue
        rel = os.path.relpath(path, ROOT)
        tree = _tree(path)
        aliases = set()         # names bound to the pipeline module
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = _resolve(path, node)
                for a in node.names:
                    if mod[-2:] == ["ops", "pipeline"] and \
                            a.name.startswith("_"):
                        bad.append(f"{rel}: imports pipeline.{a.name}")
                    if mod[-1:] == ["ops"] and a.name == "pipeline":
                        aliases.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                aliases |= {a.asname for a in node.names
                            if a.name.endswith("ops.pipeline") and a.asname}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and node.attr.startswith("_")
                    and not node.attr.startswith("__")
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases):
                bad.append(f"{rel}:{node.lineno}: pipeline.{node.attr}")
    return bad


def _resolve(path, node: ast.ImportFrom):
    """The module an ``ImportFrom`` in ``path`` names, absolute, as a
    list of its parts."""
    here = _module(path)
    pkg = here if path.endswith("__init__.py") else here[:-1]
    base = pkg[:len(pkg) - node.level + 1] if node.level else []
    return base + (node.module.split(".") if node.module else [])


def _sharded_decoder_is_no_decoder():
    from gpujpeg_tpu_torch.parallel.sharded import Mesh, ShardedDecoder
    dec = ShardedDecoder(Mesh([[torch.device("cpu")]]))
    return [a for a in ("output_to_device", "capture_device_call")
            if hasattr(dec, a)]


def _moved_names_are_gone():
    from gpujpeg_tpu_torch.models.decoder import Decoder
    from gpujpeg_tpu_torch.models.encoder import Encoder
    from gpujpeg_tpu_torch.ops import pipeline
    from gpujpeg_tpu_torch.parallel.sharded import ShardedEncoder
    gone = {Encoder: ("_tables", "_assemble", "_to_scan_bodies"),
            Decoder: ("_plan_from_info",),
            ShardedEncoder: ("_compact", "_assemble"),
            pipeline: ("_split_scan_bodies", "_enc_context", "_dec_context",
                       "_dec_run", "_EncContext", "_DecContext")}
    return [f"{getattr(o, '__name__', o)}.{n}" for o, names in gone.items()
            for n in names if hasattr(o, n)]


RULES = {
    "lower_layers_import_no_coder": _lower_layers_import_no_coder,
    "ops_take_no_coder": _ops_take_no_coder,
    "no_private_pipeline_names_outside_it":
        _no_private_pipeline_names_outside_it,
    "sharded_decoder_is_no_decoder": _sharded_decoder_is_no_decoder,
    "moved_names_are_gone": _moved_names_are_gone,
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_layering(rule):
    assert RULES[rule]() == []


def test_the_rules_see_a_breach(tmp_path, monkeypatch):
    """Each source rule finds a planted breach: an ops module importing
    ``models``, a pipeline function taking ``decoder``, and a tool
    importing a private pipeline name."""
    pkg = tmp_path / "gpujpeg_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "tools").mkdir()
    (pkg / "ops" / "pipeline.py").write_text(
        "from ..models import decoder\n\n\ndef run(decoder):\n"
        "    return decoder.stats\n")
    (pkg / "tools" / "t.py").write_text(
        "from ..ops.pipeline import _dec_run\n"
        "from ..ops import pipeline\n\npipeline._mark(None)\n")
    for clean in ("tables.py", "plan.py"):
        (pkg / clean).write_text("import numpy\n")
    (tmp_path / "chip_smoke.py").write_text("")
    me = sys.modules[__name__]
    monkeypatch.setattr(me, "ROOT", str(tmp_path))
    monkeypatch.setattr(me, "PKG", str(pkg))
    monkeypatch.setattr(me, "PIPELINE", str(pkg / "ops" / "pipeline.py"))
    assert _lower_layers_import_no_coder() == [
        "gpujpeg_tpu_torch/ops/pipeline.py imports "
        "gpujpeg_tpu_torch.models.decoder"]
    assert _ops_take_no_coder() == [
        "gpujpeg_tpu_torch/ops/pipeline.py: run(decoder)",
        "gpujpeg_tpu_torch/ops/pipeline.py:5: .stats"]
    assert _no_private_pipeline_names_outside_it() == [
        "gpujpeg_tpu_torch/tools/t.py: imports pipeline._dec_run",
        "gpujpeg_tpu_torch/tools/t.py:4: pipeline._mark"]
