"""Finds what belongs to a cell by name: its entry in BENCHMARK.json,
its configuration file, its traffic file and the readers of its
per-layer metrics.  Nothing here names a cell, a configuration or a
metric: a new one is new files and a new entry.

  gpubench/configs/<config>.json   the configuration (named by the
                                   entry's "file")
  gpubench/traffic/<traffic>.json  the traffic mix
  gpubench/metrics/<metric>.py     a per-layer metric's reader: a
                                   function read(trace) -> float | None
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Cell:
    """One entry of BENCHMARK.json's workloads, with its configuration,
    its traffic and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as fp:
            self.config = json.load(fp)
        here = os.path.join(root, os.path.dirname(
            os.path.dirname(self.config_entry["file"])))
        with open(os.path.join(here, "traffic",
                               self.entry["traffic"] + ".json")) as fp:
            self.traffic = json.load(fp)
        self.metrics_dir = os.path.join(here, "metrics")
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        return json.load(fp)


def reader(metrics_dir: str, metric: str):
    """The read(trace) function of a per-layer metric, from its file."""
    path = os.path.join(metrics_dir, metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "gbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
