"""A whole run of each cell on the card, from the command line, with a
short window (python -m pytest gpubench/tests -m card on a machine with
a CUDA device)."""

import json
import os
import subprocess
import sys

import pytest

from gbench.registry import HERE, ROOT, load_benchmark


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load_benchmark()["workloads"]])
def test_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         load_benchmark()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
