"""``BENCHMARK.json`` keeps to the benchmark format's rules, every cell
resolves to its files, and pieces added as files are found by name."""
import json
import os
import re

import pytest

from conftest import ROOT, copy_bench
from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24      # the most cells a later benchmark may have
    runs = 2 + 14 * n
    assert runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    assert len(names) == len(BENCH["configs"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] and cell.traffic["name"]
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        for moved in [m.get("moves")] if "moves" in m else []:
            assert moved in {e["name"] for e in cell.end_to_end}


def test_added_files_found_by_name(tmp_path):
    root = copy_bench(str(tmp_path))
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "configs",
                           "video_hd_i420_q75.json")) as f:
        cfg = json.load(f)
    cfg["quality"] = 90
    with open(os.path.join(bench_dir, "configs", "video_hd_q90.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "host.json")) as f:
        mix = json.load(f)
    mix["output"] = "device"
    with open(os.path.join(bench_dir, "traffic", "short_trace.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "metrics", "enc.calls.py"), "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "video_hd_q90", "source": "x",
                             "file": "portbench/configs/video_hd_q90.json",
                             "reduced": ["quality"], "why": "x"})
    bench["workloads"].append({"name": "video_hd_q90.short_trace",
                               "config": "video_hd_q90",
                               "traffic": "short_trace", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "enc.calls", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "encode_mpix_s",
                               "workloads": ["video_hd_q90.short_trace"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("video_hd_q90.short_trace", root)
    assert cell.config["quality"] == 90 and cell.traffic["output"] == "device"
    assert "enc.calls" in {m["name"] for m in cell.per_layer}
    assert spec.reader("enc.calls", root)(None) == 42.0
    assert "enc.calls" not in {m["name"] for m in spec.load_cell(
        "still8k.host", root).per_layer}
