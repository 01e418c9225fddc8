"""Small cells for the CPU tests: the repository's cells, cut to a file
of a few tens of KB, run by the harness on the CPU (the program's plain
walks in place of its kernels)."""

from __future__ import annotations

import copy
import time

from gbench import registry, window


# the SEQ and FQZ models the -5 archive holds at its 16 MB, made the
# block's only candidates: at a few tens of KB the trial keeps rANS
ADAPTIVE = ["-s", "1", "-S", "12", "-B", "-q", "1", "-Q", "1"]


def small_cell(name: str, file_bytes: int = 40_000) -> registry.Cell:
    cell = registry.Cell(registry.load_benchmark(), name)
    cell.config = dict(cell.config, file_bytes=file_bytes)
    return cell


# IonTorrent-like reads, a shape no cell states yet: lengths of 25-400
# bases from a histogram, quality falling along each read's own length
# and lower inside homopolymers, and SRA's names, which hold the read's
# number twice.  At -5 the trial keeps FQZ for its qualities.
RAGGED = {
    "read_length": {"histogram": [[25, 99, 2], [100, 199, 4],
                                  [200, 299, 3], [300, 400, 1]],
                    "length_seed": 1238539},
    "names": {"format": "SRR1238539.{n} {n}/1"},
    "quality": {"fall_along": "read", "start_mean": 33, "end_mean": 18,
                "phred_max": 38, "fall_power": 1.5, "noise_sd": 0.3,
                "noise_sd_end": 0.8, "cycle_sd": 0.0,
                "homopolymer_drop": [4, 8, 12, 16]},
}


def ragged_config(file_bytes: int = 2_000_000,
                  base: str = "err174310-l5.roundtrip") -> dict:
    """The configuration of base with RAGGED's shape in place of its own."""
    cfg = copy.deepcopy(small_cell(base, file_bytes).config)
    cfg["read_length"] = copy.deepcopy(RAGGED["read_length"])
    for group in ("names", "quality"):
        cfg[group].update(RAGGED[group])
    return cfg


def ragged_cell(base: str, file_bytes: int = 40_000) -> registry.Cell:
    """The cell base with RAGGED's reads."""
    cell = small_cell(base, file_bytes)
    cell.config = ragged_config(file_bytes, base)
    return cell


def cpu_run(monkeypatch, cell, seed: int = 2 ** 31 + 7,
            seconds: float = 0.01, before_window=None) -> window.Run:
    """A run of cell on the CPU: set-up, window and check."""
    import torch
    from fqzcomp5_tpu_torch import cli

    monkeypatch.setattr(cli, "_cuda_device",
                        lambda what: torch.device("cpu"))
    if {"SEQ", "FQZ"} & set(cell.config["archive_holds"]):
        parse = cli.parse_args
        monkeypatch.setattr(cli, "parse_args",
                            lambda argv: parse([*argv[:1], *ADAPTIVE,
                                                *argv[1:]]))
    run = window.Run(cell, seed, seconds, False, time.perf_counter(),
                     device="cpu")
    try:
        run.setup()
        if before_window:
            before_window(run)
        run.window()
        run.checks = run.check()
    finally:
        run.cleanup()
    return run
