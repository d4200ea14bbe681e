"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic and the readers of its metrics, each found by name.

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``vrbench/traffic/<traffic>.json``;
- a metric: ``vrbench/metrics/<name>.py``, whose ``read(ctx)`` returns the
  value, or None where the run has nothing to read for it. A quantity that
  cells of different end-to-end metrics report goes by one name for each,
  ``<quantity>.<suffix>`` (a per-layer metric ``moves`` one end-to-end
  metric); without a file of that name it is read by ``<quantity>.py``.

A cell runs the end-to-end metrics that apply to it with ``--trace 0`` and
the per-layer ones with ``--trace 1``: those whose ``workloads`` name it,
an end-to-end metric with no ``workloads`` key in every cell, and a
per-layer one with no such key in every cell that reports the end-to-end
metric it ``moves``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the metrics' entries that apply to the cell
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "vrbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and ("workloads" in m or m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``vrbench/metrics/<metric>.py``, or of the
    quantity's file, the name before its first dot."""
    base = os.path.join(root, "vrbench", "metrics")
    path = os.path.join(base, f"{metric}.py")
    if not os.path.exists(path):
        metric = metric.split(".")[0]
        path = os.path.join(base, f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"vrbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
