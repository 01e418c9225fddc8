"""The port's spans and counters (fqzcomp5_tpu_torch.ops.devtimer: span,
count, current, spans) on the CPU: off, nothing is recorded and span is
one shared null context; on, spans nest per thread, a pool thread's span
takes the submitting span as its parent, each root opens a request whose
counts the counters add to, the log is bounded and reset() leaves it.
A -1 and a -5 round trip through the wave engine open every span of
their path, and the kernel wrappers' walk_symbols counters equal the
symbols the benchmark's launch tally counts from the same launches.
The -v report of the wave engine gives each section real seconds."""

import concurrent.futures as cf
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch.ops import devtimer

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENCODE_SPANS = {
    "encode", "parse/batch", "parse/container", "driver/wave",
    "driver/start", "driver/plan", "driver/assemble", "driver/lzp3",
    "driver/names", "driver/frame", "driver/write", "prep/o0", "prep/o1",
    "prep/o1_plane", "prep/pack", "prep/stripe", "prep/payload",
    "link/put", "link/get",
    "kernel/encode_walk"}
ADAPTIVE_SPANS = {
    "adaptive/pass1", "adaptive/group", "adaptive/evolve", "adaptive/rc",
    "driver/adaptive_small", "kernel/tiny_evolve", "kernel/evolve_128",
    "kernel/evolve_256", "kernel/rc_encode_walk"}
DECODE_SPANS = {
    "decode", "parse/container", "decode/split", "prep/dec_tables",
    "prep/dec_finish",
    "decode/unpack", "decode/unstripe", "decode/host_blocks",
    "decode/block", "decode/write", "link/put", "link/get",
    "kernel/decode_o1"}


@pytest.fixture
def on(monkeypatch):
    """devtimer enabled, with an empty span log of its own."""
    monkeypatch.setattr(devtimer, "enabled", True)
    monkeypatch.setattr(devtimer, "_log",
                        type(devtimer._log)(maxlen=devtimer.MAX_SPANS))
    yield devtimer
    devtimer.reset()


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(devtimer, "enabled", False)
    n = len(devtimer.spans())
    a, b = devtimer.span("driver/wave"), devtimer.span("encode", None)
    assert a is b is devtimer._NULL
    with a as got:
        assert got is None
        assert devtimer.current() is None
        devtimer.count("waves", 1)
    assert len(devtimer.spans()) == n


def test_nesting_parents_and_requests(on):
    with on.span("encode") as root:
        assert on.current() is root
        with on.span("driver/wave") as wave:
            with on.span("link/put"):
                on.count("waves", 2)
            on.count("waves", 1)
        assert on.current() is root
    with on.span("decode"):
        on.count("host_sections", 3)
    on.count("blocks", 5)                     # no request open: dropped
    assert on.current() is None
    log = {s.name: s for s in on.spans()}
    assert [s.name for s in on.spans()] == [
        "link/put", "driver/wave", "encode", "decode"]
    enc, dec = log["encode"], log["decode"]
    assert enc.parent is None and enc.request == enc.id == root.id
    assert log["driver/wave"].parent == enc.id
    assert log["link/put"].parent == wave.id
    assert {log[k].request for k in ("link/put", "driver/wave")} == {enc.id}
    assert dec.request == dec.id != enc.id
    assert enc.counts == {"waves": 3} and dec.counts == {"host_sections": 3}
    assert log["link/put"].counts is None
    for s in on.spans():
        assert s.t0_ns <= s.t1_ns
    assert enc.t0_ns <= log["driver/wave"].t0_ns
    assert log["driver/wave"].t1_ns <= enc.t1_ns


def test_pool_thread_takes_the_submitting_span(on):
    def job(parent):
        with on.span("decode/block", parent):
            on.count("host_sections", 1)

    with on.span("decode") as root:
        with on.span("decode/host_blocks"):
            cur = on.current()
            with cf.ThreadPoolExecutor(max_workers=2) as pool:
                list(pool.map(job, [cur] * 4))
    log = on.spans()
    blocks = [s for s in log if s.name == "decode/block"]
    host = next(s for s in log if s.name == "decode/host_blocks")
    assert len(blocks) == 4
    assert all(s.parent == host.id and s.request == root.id for s in blocks)
    assert all(s.thread != host.thread for s in blocks)
    assert next(s for s in log if s.name == "decode").counts == {
        "host_sections": 4}


def test_log_is_bounded_and_reset_keeps_it(on):
    assert on._log.maxlen == on.MAX_SPANS == 65536
    for _ in range(on.MAX_SPANS + 10):
        with on.span("driver/frame"):
            pass
    log = on.spans()
    assert len(log) == on.MAX_SPANS
    assert log[-1].id - log[0].id == on.MAX_SPANS - 1
    on.reset()
    assert len(on.spans()) == on.MAX_SPANS
    log.clear()                                # spans() is a copy
    assert len(on.spans()) == on.MAX_SPANS


def _fastq(path, nrec, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(nrec):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 100)])
        q = (np.cumsum(rng.integers(-2, 3, 100)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@D.{i}\n{seq}\n+\n{q}\n")
    path.write_text("".join(recs))
    return path


@pytest.mark.parametrize("preset", ["-1", "-5"])
def test_round_trip_spans_and_walk_symbols(tmp_path, on, preset):
    """264 records in 16 KB blocks: three trial blocks and a last one
    whose sections are under MIN_DEVICE (host codecs).  Every span of
    the path opens under its request, the candidates' bytes are
    counted, and each walk's walk_symbols counter equals the symbols
    gbench.tracing.Launches counts from the same launches."""
    sys.path.insert(0, os.path.join(ROOT, "gpubench"))
    try:
        from gbench import tracing
    finally:
        sys.path.remove(os.path.join(ROOT, "gpubench"))
    src = _fastq(tmp_path / "in.fastq", 264, seed=7)
    arg, _, _ = cli.parse_args([preset, "-V"])
    arg.blk_size = 16_000
    with tracing.Launches() as seen:
        blob = io.BytesIO()
        cuda_driver.encode_file(str(src), blob, arg, Timings(), CPU)
        out = io.BytesIO()
        cuda_driver.decode_file(io.BytesIO(blob.getvalue()),
                                make_fastq_writer(out, arg), arg, Timings(),
                                CPU)
    assert out.getvalue() == src.read_bytes()
    log = on.spans()
    roots = [s for s in log if s.parent is None]
    assert [r.name for r in roots] == ["encode", "decode"]
    enc, dec = roots
    names = {r.id: {s.name for s in log if s.request == r.id}
             for r in roots}
    want_enc = ENCODE_SPANS | (ADAPTIVE_SPANS if preset == "-5" else set())
    assert names[enc.id] >= want_enc
    assert names[dec.id] >= DECODE_SPANS
    assert all(s.name.split("/")[0] in (
        "parse", "driver", "prep", "adaptive", "link", "kernel")
        for s in log if s.request == enc.id and s is not enc)
    assert all(s.name.split("/")[0] in (
        "parse", "decode", "prep", "link", "kernel")
        for s in log if s.request == dec.id and s is not dec)
    c = enc.counts
    # o0 and o1 walk every section of a trial block at least
    assert c["candidate_bytes"] > 264 * 200
    assert c["blocks"] == 4 and c["waves"] == 1
    assert c["parse_bytes"] > 0
    assert c["trial_blocks"] + c["locked_blocks"] == 8   # seq and qual
    if preset == "-5":
        assert c["adaptive_jobs_device"] > 0 and c["adaptive_jobs_host"] > 0
        assert c["pass2_events"] > 0 and c["rc_chunks"] > 0
        assert (c["plane_events"] == c["group_events"]
                == c["pass2_events"])
    assert dec.counts["host_sections"] >= 4
    tallied = {}
    for walk, _, syms, _ in seen.seen:
        tallied[walk] = tallied.get(walk, 0) + int(syms)
    counted = {}
    for r in roots:
        for k, v in r.counts.items():
            if k.startswith("walk_symbols/"):
                walk = k.removeprefix("walk_symbols/")
                counted[walk] = counted.get(walk, 0) + v
    assert tallied and counted == tallied


def test_verbose_report_times_each_section(tmp_path, monkeypatch, capsys):
    """-v on the wave engine: the NAME section's seconds are its own
    compress calls', the SEQ and QUAL sections' their segment tasks'
    (never the 0.00 sec of a section nobody timed)."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(1500):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 100)])
        q = (np.cumsum(rng.integers(-2, 3, 100)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        # 2 KB names, so their seconds show at two decimals (about 0.03)
        name = (f"ERR174310.{i} HSQ1004:134:C0D8DACXX:1:{1101 + i % 7}:"
                f"{rng.integers(1000, 20000)}:{rng.integers(1000, 200000)}"
                f"/1 {rng.bytes(1000).hex()}")
        recs.append(f"@{name}\n{seq}\n+\n{q}\n")
    src = tmp_path / "in.fastq"
    src.write_text("".join(recs))
    monkeypatch.setattr(cli, "_cuda_device", lambda what: CPU)
    arg, _, _ = cli.parse_args(["-1", "-v"])
    arg.blk_size = 64_000
    t = Timings()
    encode, _, _ = cli._engine(arg, t, False)
    encode(str(src), io.BytesIO())
    t.report()
    err = capsys.readouterr().err
    assert t.nblock > 1 and t.ntime > 0 and t.stime > 0 and t.qtime > 0
    final = err[err.index("blocks combined"):]
    for sec in ("Names", "Seqs", "Qual"):
        secs = float(re.search(rf"^{sec} .* in ([0-9.]+) sec", final,
                               re.M).group(1))
        assert secs > 0, (sec, final)
    per_block = re.findall(r"^(Seqs|Quals) .* in ([0-9.]+) sec",
                           err[:err.index("blocks combined")], re.M)
    assert len(per_block) == 2 * t.nblock
    assert all(float(s) > 0 for _, s in per_block)
