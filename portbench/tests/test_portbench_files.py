"""Every configuration, cell, traffic mix and metric of BENCHMARK.json is
found by its name, and the file keeps to the benchmark's format."""

import json
import os
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: keys that name a width, which a configuration's cut may never change
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|head|width")


@pytest.fixture(scope="module")
def bench():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return root, json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    _, b = bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32


def test_configs(bench):
    root, b = bench
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(root, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)


def test_cells_and_metrics(bench):
    root, b = bench
    cells = {w["name"] for w in b["workloads"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        got = spec.load_cell(root, cell)
        assert got.end_to_end and got.per_layer
        assert any(m.name == "setup_s" for m in got.end_to_end)
        assert len(got.end_to_end) >= 2
    # each per-layer metric's cells report the metric it moves
    for m in b["per_layer"]:
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= \
            set(moved.get("workloads", cells))


def test_everything_loads_by_name(bench):
    root, b = bench
    for w in b["workloads"]:
        cell = spec.load_cell(root, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(spec.loadgen(cell.traffic).drive)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.load_cell(root, "no_such_cell")


def test_size_and_layers_in_perf_md(bench):
    root, b = bench
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) < 64 << 10
    with open(os.path.join(root, "PERF.md")) as fh:
        perf = fh.read()
    for m in b["per_layer"]:
        assert m["layer"] in perf, m["layer"]
