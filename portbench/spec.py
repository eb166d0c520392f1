"""What ``BENCHMARK.json`` and the files it names say about one cell.

A cell is one entry of ``workloads``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``loadgen`` names the
module of ``portbench/loadgen/`` that runs it). Each metric is read by
``portbench/metrics/<metric name>.py``. Everything is found by name, so
a new configuration, mix or metric is new files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    config_text: str
    traffic_name: str
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: str):
    with open(path) as fh:
        text = fh.read()
    return json.loads(text), text


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; KeyError if absent."""
    bench, _ = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config, config_text = _load_json(os.path.join(root, conf["file"]))
    traffic, _ = _load_json(os.path.join(HERE, "traffic",
                                         w["traffic"] + ".json"))

    def metrics(key):
        return [Metric(m["name"], m["unit"])
                for m in bench[key] if _applies(m, name)]

    return Cell(name, int(w["chips"]), w["config"], config, config_text,
                w["traffic"], traffic, metrics("end_to_end"),
                metrics("per_layer"))


def loadgen(traffic: dict):
    """The module of ``portbench/loadgen/`` that runs this mix."""
    return importlib.import_module(f"portbench.loadgen.{traffic['loadgen']}")


def reader(metric: str):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``
    (a metric's name may hold dots, so it is loaded by path)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
