"""One run of a cell: the input from the seed, the warm-up, the measured
window of round trips, and the check of what the window produced.

A request is a round trip of one file through the engine functions the
port's CLI binds for ``-e cuda`` (``cli._engine``): encode the file from
disk into an in-memory archive, then decode that archive into in-memory
FASTQ, as many times as the traffic's ``decodes_per_round_trip`` says.
Round trips run back to back until the window's seconds are up; the one
running then is finished and counted.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import os
import random
import sys
import tempfile
import time

from gbench import ref_archive, tracing, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "fqzcomp5_tpu")
MB = 1e6
# distinct archives the reference reads in a run (drawn from the seed
# where there are more; the encoder is deterministic, so a sound run makes
# one): the SEQ and FQZ payloads of 6 million bases and qualities take
# the plain decoders 20-40 s
ARCHIVE_SAMPLE = 4


class Port:
    """The program under test: encode and decode of one preset."""

    def __init__(self, preset: str):
        from fqzcomp5_tpu_torch import cli, drivers

        self.drivers = drivers
        self.arg, _, _ = cli.parse_args([preset, "-V"])
        t = drivers.Timings()
        self._encode, _, _ = cli._engine(self.arg, t, False)
        _, _, self._decode = cli._engine(self.arg, t, True)

    def encode(self, path: str) -> bytes:
        sink = io.BytesIO()
        self._encode(path, sink)
        return sink.getvalue()

    def decode(self, archive: bytes, sink: Sink | None = None):
        """The FASTQ of the archive, written into sink (a fresh one by
        default); returns the bytes written, as a view of the sink."""
        sink = Sink(len(archive) * 8) if sink is None else sink
        sink.reset()
        self._decode(io.BytesIO(archive),
                     self.drivers.make_fastq_writer(sink, self.arg))
        return sink.data()


class Sink:
    """A write-only file over a buffer made once, its pages touched, and
    reused by every decode of the window, so that no decode pays for the
    harness's memory (a fresh 128 MB buffer is tens of thousands of page
    faults, and a copy at the end)."""

    def __init__(self, capacity: int):
        self._buf = bytearray(max(1, capacity))
        self._buf[::4096] = b"\1" * len(range(0, len(self._buf), 4096))
        self._n = 0

    def reset(self) -> None:
        self._n = 0

    def write(self, b) -> int:
        m = len(b)
        if self._n + m > len(self._buf):
            # a new buffer: views of the old one stay as they were
            old = self._buf
            self._buf = bytearray(2 * (self._n + m))
            self._buf[:self._n] = old[:self._n]
        self._buf[self._n:self._n + m] = b
        self._n += m
        return m

    def data(self) -> memoryview:
        return memoryview(self._buf)[:self._n]


def verdict(checks: dict, trips) -> bool:
    """correct: every number compared within its limit, and at least one
    round trip made."""
    return bool(trips) and all(c["value"] <= c["limit"]
                               for c in checks.values())


def forbidden_modules() -> list[str]:
    """Top-level modules of JAX or of the JAX package now loaded."""
    top = {name.split(".")[0] for name in sys.modules}
    return sorted(top & set(FORBIDDEN))


class Trip:
    """One round trip's measurements."""

    def __init__(self):
        self.error = ""
        self.archive = b""
        self.diff_bytes = 0
        self.enc_s = self.dec_s = 0.0
        self.in_bytes = self.out_bytes = 0
        self.enc_link = self.dec_link = 0
        self.enc_peak = 0
        self.enc_launches = self.dec_launches = 0


def _span(name: str, traced: bool):
    if not traced:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def diff_bytes(a: bytes, b: bytes) -> int:
    """Bytes at which a and b differ, counting a length difference."""
    import numpy as np

    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int((x != y).sum()) + abs(len(a) - len(b))


class Card:
    """The device's memory statistics and synchronisation (no-ops on the
    CPU, where tests drive a run)."""

    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.cuda = device == "cuda"

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


def round_trip(port: Port, path: str, data: bytes, card: Card,
               sink: Sink | None = None, traced: bool = False,
               launches=None, decodes: int = 1) -> Trip:
    """Encode the file at path, then decode the archive into sink the
    given number of times, each output compared with data.  Traced, also
    the devtimer counters, the encode's peak device memory and the kernel
    launches of each direction (the wrappers' counters: host integers, no
    work on the device).  With launches (a tracing.Launches, outside the
    window), each launch's span."""
    if traced:
        from fqzcomp5_tpu_torch.ops import devtimer

    def mark(span):
        if launches is not None:
            launches.span = span
    tr = Trip()
    tr.in_bytes = len(data)
    try:
        if traced:
            devtimer.reset()
            card.reset_peak()
        n0 = tracing.launch_count()
        mark("encode")
        with _span("encode", traced):
            t = time.perf_counter()
            tr.archive = port.encode(path)
            tr.enc_s = time.perf_counter() - t
        n1 = tracing.launch_count()
        tr.enc_launches = n1 - n0
        if traced:
            tr.enc_link = devtimer.snapshot()["link_bytes"]
            tr.enc_peak = card.peak()
            devtimer.reset()
        mark("decode")
        for _ in range(decodes):
            with _span("decode", traced):
                t = time.perf_counter()
                out = port.decode(tr.archive, sink)
                tr.dec_s += time.perf_counter() - t
            tr.out_bytes += len(out)
            tr.diff_bytes += diff_bytes(out, data)
        tr.dec_launches = tracing.launch_count() - n1
        mark(None)
        if traced:
            tr.dec_link = devtimer.snapshot()["link_bytes"]
    except Exception as e:     # a failed request is counted, not fatal
        tr.error = f"{type(e).__name__}: {e}"
    return tr


class Run:
    """Set-up, window and check of one run of a cell."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 started: float, device: str = "cuda"):
        self.card = Card(device)
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.started = started
        self.peak = 0
        self.extra_paths = []
        self.launches = []

    def setup(self) -> None:
        """Input from the seed, the port and its CUDA context, warm-up."""
        cfg = self.cell.config
        self.reads = traffic.reads(cfg, self.seed)
        self.data = traffic.fastq(self.reads)
        tmp = tempfile.gettempdir()
        self.path = os.path.join(tmp, f"gpubench-{self.cell.name}-"
                                      f"{self.seed}.fastq")
        with open(self.path, "wb") as fp:
            fp.write(self.data)
        if self.card.cuda:
            self.card.torch.zeros(1, device="cuda")
        self.port = Port(cfg["preset"])
        self.sink = Sink(len(self.data) + (1 << 20))
        # whole-file round trips, so that the window's first one finds
        # every buffer and table of its sizes made (set-up only: what
        # they produce is not checked)
        self.decodes = self.cell.traffic["decodes_per_round_trip"]
        for _ in range(self.cell.traffic["warmup_round_trips"]):
            round_trip(self.port, self.path, self.data, self.card, self.sink,
                       decodes=self.decodes)
        self.card.sync()
        # what set-up made stays: the window's collections skip it
        gc.collect()
        gc.freeze()

    def window(self) -> None:
        self.peak = self.card.peak()
        self.setup_s = time.perf_counter() - self.started
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU]
                           + [ProfilerActivity.CUDA] * self.card.cuda)
        self.trips = []
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < self.seconds:
                tr = round_trip(self.port, self.path, self.data, self.card,
                                self.sink, self.trace, decodes=self.decodes)
                self.peak = max(self.peak, tr.enc_peak, self.card.peak())
                self.trips.append(tr)
            self.card.sync()
            self.window_s = time.perf_counter() - t0
        self.peak = max(self.peak, self.card.peak())
        self.prof = prof

    def tally(self) -> None:
        """The work of each kernel launch, after the window: one more round
        trip, each launch's symbols and bytes counted as it returns
        (tracing.Launches, with reductions on the device that the window
        must not hold).  The encoder and the decoder are deterministic, so
        a window's round trip that made as many launches in a direction
        made these; a direction in which one did not is left uncounted,
        and its roofline share unread."""
        with tracing.Launches() as seen:
            tr = round_trip(self.port, self.path, self.data, self.card,
                            Sink(0), launches=seen, decodes=self.decodes)
        if tr.error:
            return
        per_symbol = {order: nbytes / syms for order, (syms, nbytes)
                      in ref_archive.card_streams(tr.archive).items()
                      if syms}
        work = seen.totals(per_symbol)
        trips = [t for t in self.trips if not t.error]
        for span, made in (("encode", "enc_launches"),
                           ("decode", "dec_launches")):
            mine = [w for w in work if w["span"] == span]
            if trips and all(getattr(t, made) == len(mine) for t in trips):
                self.launches += mine * len(trips)

    def check(self) -> dict:
        """Hold every decode against the input, and the distinct archives
        (a sample drawn from the seed) against the plain reference;
        returns the numbers compared with their limits."""
        rnd = random.Random(self.seed)
        archives = {}
        for tr in self.trips:
            if tr.archive:
                archives.setdefault(hashlib.sha256(tr.archive).digest(),
                                    tr.archive)
        keys = sorted(archives)
        if len(keys) > ARCHIVE_SAMPLE:
            keys = rnd.sample(keys, ARCHIVE_SAMPLE)
        bad = {}
        held = set()
        self.ref_errors = []
        for k in keys:
            rep = ref_archive.check(archives[k], self.reads)
            bad[k] = rep.bad_blocks
            held |= rep.kinds
            if rep.first_error:
                self.ref_errors.append(rep.first_error)
        missing = [k for k in self.cell.config["archive_holds"]
                   if k not in held]
        if missing:
            self.ref_errors.append("no archive read holds "
                                   + ", ".join(missing))
        for tr in self.trips:
            key = hashlib.sha256(tr.archive).digest() if tr.archive else None
            tr.failed = bool(tr.error or tr.diff_bytes
                             or (key in bad and bad[key]))
        return {
            "decoded_bytes_differing": {
                "value": sum(tr.diff_bytes for tr in self.trips),
                "limit": 0},
            "archive_blocks_failing_reference": {
                "value": sum(bad.values()), "limit": 0},
            "section_kinds_not_read": {"value": len(missing), "limit": 0},
            "round_trips_failing": {
                "value": sum(tr.failed for tr in self.trips), "limit": 0},
        }

    def cleanup(self) -> None:
        for p in (self.path, *self.extra_paths):
            with contextlib.suppress(OSError):
                os.remove(p)
