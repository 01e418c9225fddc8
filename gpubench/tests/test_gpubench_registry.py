"""Cells, configurations, traffic and metric readers are found by name,
and one added as new files is found without touching the harness."""

import json
import os
import shutil

from gbench import registry


def test_every_cell_and_metric_resolves():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cell = registry.Cell(bench, w["name"])
        assert cell.config["preset"].startswith("-")
        assert cell.traffic["warmup_round_trips"] >= 1
        assert cell.traffic["decodes_per_round_trip"] >= 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(registry.reader(cell.metrics_dir, m["name"]))


def test_a_cell_added_as_files(tmp_path):
    here = registry.HERE
    root = tmp_path / "repo"
    shutil.copytree(here, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark()
    cfg = json.load(open(os.path.join(here, "configs",
                                      "err174310-l1.json")))
    cfg.update(name="extra", preset="-3")
    (root / "gpubench" / "configs" / "extra.json").write_text(
        json.dumps(cfg))
    (root / "gpubench" / "traffic" / "twice.json").write_text(
        json.dumps({"warmup_round_trips": 2}))
    (root / "gpubench" / "metrics" / "answer.extra.py").write_text(
        "def read(trace):\n    return 42.0\n")
    bench["configs"].append({"name": "extra", "source": "x",
                             "file": "gpubench/configs/extra.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra.twice", "config": "extra",
                               "traffic": "twice", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answer.extra", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "setup_s",
                               "workloads": ["extra.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.Cell(registry.load_benchmark(str(root)), "extra.twice",
                         str(root))
    assert cell.config["preset"] == "-3"
    assert cell.traffic == {"warmup_round_trips": 2}
    assert [m["name"] for m in cell.per_layer] == ["answer.extra"]
    assert registry.reader(cell.metrics_dir, "answer.extra")(None) == 42.0
