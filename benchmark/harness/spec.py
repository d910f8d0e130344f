"""Finds what a cell needs by name: its entry of ``BENCHMARK.json``, its
configuration's file, its traffic's file, its per-layer metrics' readers
and its configuration's limits. Nothing here knows a cell, a
configuration, a traffic mix or a metric by name: a later change adds one
as files and entries.

- ``BENCHMARK.json`` (the checkout's root): the cells, the configurations
  (``file``), the metrics and the cells each per-layer metric is read in.
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters.
- ``benchmark/metrics/<metric>.py``: a reader ``read(trace)`` that returns
  the metric's value, or None where it finds nothing to read.
- ``benchmark/limits/<config>.json``: the limit of each number that the
  correctness comparison reads, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import yaml

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file as read (the system's YAML, plus the benchmark's keys)
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: Dict[str, dict]  # name -> entry, the metrics this cell reports
    readers: Dict[str, Callable] = field(default_factory=dict)
    limits: dict = field(default_factory=dict)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = yaml.safe_load(f)
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", f"{w['config']}.json")) as f:
        limits = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"] if _reports(m, name)}
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=per_layer,
        readers={m: load_reader(m, bench_dir) for m in per_layer},
        limits=limits,
    )
