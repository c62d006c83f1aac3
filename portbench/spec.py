"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration is ``configs/<config>.json`` (the file that
``configs`` gives), the mix ``traffic/<traffic>.json``, and each metric
a reader ``metrics/<name>.py`` with a function ``read(run)`` that
returns the metric's value or None. A later cell, mix or metric is added
as files and entries; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

#: the folder of the benchmark; its parent is the checkout's root
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    #: end-to-end and per-layer metric entries that this cell reports
    end_to_end: list
    per_layer: list
    root: str


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, mix and metrics; ``root`` defaults to the checkout
    that holds this file."""
    root = root or os.path.dirname(HERE)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    config["name"] = conf["name"]
    with open(os.path.join(root, os.path.basename(HERE), "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    traffic["name"] = w["traffic"]
    return Cell(name, config, traffic, w["chips"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], root)


def reader(name: str, root: str | None = None):
    """The ``read`` function of ``metrics/<name>.py`` in ``root``'s
    benchmark folder."""
    path = os.path.join(root or os.path.dirname(HERE),
                        os.path.basename(HERE), "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
