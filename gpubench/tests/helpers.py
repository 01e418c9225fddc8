"""Small cells for the CPU tests: the repository's cells, cut to a file
of a few tens of KB, run by the harness on the CPU (the program's plain
walks in place of its kernels)."""

from __future__ import annotations

import time

from gbench import registry, window


# the SEQ and FQZ models the -5 archive holds at its 16 MB, made the
# block's only candidates: at a few tens of KB the trial keeps rANS
ADAPTIVE = ["-s", "1", "-S", "12", "-B", "-q", "1", "-Q", "1"]


def small_cell(name: str, file_bytes: int = 40_000) -> registry.Cell:
    cell = registry.Cell(registry.load_benchmark(), name)
    cell.config = dict(cell.config, file_bytes=file_bytes)
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
