"""A whole run of each cell on the card, from the command line, with a
short window (python -m pytest gpubench/tests -m card on a machine with
a CUDA device)."""

import json
import os
import subprocess
import sys
import time

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


@pytest.mark.card
def test_ragged_round_trip_on_the_card(tmp_path):
    # a 4 MB file of reads of 25-400 bases through the -e cuda -5 engine
    # the cells time: decoded as it went in, every block reference-correct
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gbench import ref_archive, traffic, window
    from helpers import ragged_config

    r = traffic.reads(ragged_config(4_000_000), 2 ** 34 + 77)
    data = traffic.fastq(r)
    path = tmp_path / "ragged.fastq"
    path.write_bytes(data)
    port = window.Port("-5")
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        archive = port.encode(str(path))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    print(f"ragged -5 encode of {len(data)} bytes ({len(r)} reads), s:",
          walls, "device:", torch.cuda.get_device_name(0))
    assert bytes(port.decode(archive)) == data
    rep = ref_archive.check(archive, r)
    assert rep.bad_blocks == 0 and rep.first_error == ""
    assert rep.records == len(r) and "FQZ" in rep.kinds


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
