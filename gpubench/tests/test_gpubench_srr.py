"""The SRR1238539-shaped -5 cell on the CPU: its configuration draws a
file of its size, of lengths from its histogram, the same for every
seed; a small run of the cell reads correct, and its control reads not
correct through the bytes it changes; pass1_cells_per_symbol.encode
reads the pass-1 counters of the window's encodes."""

import numpy as np
import pytest

from gbench import control, registry, traffic, window

import helpers
from test_gpubench_program_spans import WINDOW, Log, Trace
from test_gpubench_program_spans import read as read_metric

CELL = "srr1238539-l5.roundtrip"
# what the archive of the cell's 16 MB file holds (rANS bases, FQZ
# qualities), made the only candidates: at a few tens of KB the trial
# keeps SEQ for the bases and rANS for the qualities
SMALL = ["-s", "0", "-Q", "1"]


def _config():
    return registry.Cell(registry.load_benchmark(), CELL).config


def test_file_size():
    cfg = _config()
    r = traffic.reads(cfg, 2 ** 31 + 7)
    assert abs(len(traffic.fastq(r)) / cfg["file_bytes"] - 1) < 0.02


def test_lengths_lie_in_the_histogram():
    cfg = _config()
    lens = traffic.lengths(cfg, traffic.nreads(cfg))
    bins = np.array(cfg["read_length"]["histogram"])
    inside = ((lens[:, None] >= bins[:, 0]) & (lens[:, None] <= bins[:, 1]))
    assert inside.any(1).all()
    # every bin is drawn, the shortest and the longest length too
    assert inside.any(0).all()
    assert lens.min() == bins[:, 0].min() and lens.max() == bins[:, 1].max()


def test_every_seed_draws_the_same_lengths():
    cfg = _config()
    a, b = (traffic.reads(cfg, s, n=3000) for s in (5, 2 ** 32 + 9))
    assert np.array_equal(a.lens, b.lens)
    assert not np.array_equal(a.qual, b.qual)


def _cpu_run(monkeypatch, before_window=None):
    """A run of the cell cut to 40 KB on the CPU, with SMALL's options."""
    monkeypatch.setattr(helpers, "ADAPTIVE", SMALL)
    return helpers.cpu_run(monkeypatch, helpers.small_cell(CELL),
                           before_window=before_window)


def test_small_run_is_correct(monkeypatch):
    run = _cpu_run(monkeypatch)
    assert window.verdict(run.checks, run.trips), run.checks
    assert all(c["value"] == 0 for c in run.checks.values())


def test_control_is_not_correct(monkeypatch):
    run = _cpu_run(monkeypatch, before_window=control.install)
    assert not window.verdict(run.checks, run.trips)
    # the binned qualities are encoded (no round trip raises) and read
    # back as they were binned
    assert run.trips and not any(t.error for t in run.trips)
    assert run.checks["decoded_bytes_differing"]["value"] > 0
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0


@pytest.fixture
def program(monkeypatch):
    from gbench import program_spans

    def use(records):
        monkeypatch.setattr(program_spans, "program_log", lambda: records)
    return use


def _log(counts):
    """A window of two round trips whose encodes count counts, between a
    warm-up and a tally round trip that count ten times as much."""
    log = Log()
    big = {k: 10 * v for k, v in counts.items()}
    log.round_trip(-27_000, big)
    for s in WINDOW:
        log.round_trip(s, counts)
    log.round_trip(45_000, big)
    return log.records


def test_pass1_cells_per_symbol(program):
    # two planes a job (FQZ, SEQ) of 1,000 records, the longest 400
    # bases and the mean 180
    R, L, mean = 1000, 400, 180
    program(_log({"pass1_cells": 2 * R * L, "pass1_symbols": 2 * R * mean}))
    assert read_metric("pass1_cells_per_symbol.encode",
                       Trace(WINDOW)) == pytest.approx(L / mean)


def test_pass1_cells_per_symbol_without_counters(program):
    program(_log({"candidate_bytes": 3000}))
    assert read_metric("pass1_cells_per_symbol.encode", Trace(WINDOW)) is None
    program(None)
    assert read_metric("pass1_cells_per_symbol.encode", Trace(WINDOW)) is None
