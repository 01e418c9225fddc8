"""The port's FQZ5_DEVTIME accounting (fqzcomp5_tpu_torch.ops.devtimer)
on the CPU, where its counters come from perf_counter: disabled, the
helpers are plain call-throughs that count nothing; enabled, the wave
engine's archives are byte-identical to the disabled run's and the
link and compute counters move.  The snapshot's keys are the JAX
module's."""

import io
import sys
import threading

import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import devtimer as jax_devtimer
from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch.ops import devtimer

CPU = torch.device("cpu")
ZERO = {"link_s": 0.0, "link_bytes": 0, "compute_s": 0.0,
        "compute_calls": 0}


@pytest.fixture
def timer(monkeypatch):
    """devtimer with its counters reset before and after the test, and
    a span log of its own."""
    monkeypatch.setattr(devtimer, "_log",
                        type(devtimer._log)(maxlen=devtimer.MAX_SPANS))
    devtimer.reset()
    yield devtimer
    monkeypatch.setattr(devtimer, "enabled", False)
    devtimer.reset()


def test_snapshot_keys_equal_the_jax_module(timer):
    assert set(timer.snapshot()) == set(jax_devtimer.snapshot())
    assert timer.snapshot() == ZERO


def test_disabled_helpers_call_through(timer, monkeypatch):
    monkeypatch.setattr(timer, "enabled", False)
    a = np.arange(10, dtype=np.int32)[::2]   # not contiguous
    t = timer.put(a, CPU)
    assert t.dtype == torch.int32 and t.tolist() == a.tolist()
    g = timer.get(t + 1)
    assert isinstance(g, np.ndarray) and g.tolist() == (a + 1).tolist()
    assert timer.compute(lambda: (t * 2, 7), CPU)[1] == 7
    assert timer.snapshot() == ZERO


def test_enabled_helpers_count(timer, monkeypatch):
    monkeypatch.setattr(timer, "enabled", True)
    a = np.arange(1000, dtype=np.int64)
    t = timer.put(a, CPU)
    assert timer.get(t).tolist() == a.tolist()
    assert timer.compute(lambda: t.sum(), CPU).item() == a.sum()
    snap = timer.snapshot()
    assert snap["link_bytes"] == 2 * a.nbytes
    assert snap["compute_calls"] == 1
    assert snap["link_s"] >= 0 and snap["compute_s"] >= 0
    timer.reset()
    assert timer.snapshot() == ZERO


def test_counters_under_many_threads(timer, monkeypatch):
    """Threads count at once, as the per-block route's do: no update is
    lost (more threads than cores, a short switch interval)."""
    monkeypatch.setattr(timer, "enabled", True)
    a = np.arange(64, dtype=np.int32)
    nthreads, reps = 32, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                timer.get(timer.compute(lambda: timer.put(a, CPU) + 1, CPU))
        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = timer.snapshot()
    assert snap["link_bytes"] == nthreads * reps * 2 * a.nbytes
    assert snap["compute_calls"] == nthreads * reps


@pytest.mark.parametrize("on", [False, True])
def test_timed_counts_each_wrapper_call(timer, monkeypatch, on):
    """devtimer.timed: one compute call per call of the decorated
    wrapper when enabled, none when disabled; the result, keywords,
    name and attributes pass through.  Enabled, each call is also a
    kernel/<walk> span."""
    monkeypatch.setattr(timer, "enabled", on)
    n = len(timer.spans())

    @timer.timed("walk")
    def wrapper(t, k=1):
        """doc"""
        return t + k
    wrapper.launches = 0
    t = torch.arange(4)
    with timer.span("encode"):
        assert wrapper(t, k=2).tolist() == [2, 3, 4, 5]
        assert wrapper(t).tolist() == [1, 2, 3, 4]
    assert timer.snapshot()["compute_calls"] == 2 * on
    assert timer.snapshot()["link_bytes"] == 0
    assert (wrapper.__name__, wrapper.__doc__) == ("wrapper", "doc")
    assert wrapper.launches == 0
    new = timer.spans()[n:]
    if not on:
        assert new == []
        return
    assert [s.name for s in new] == ["kernel/walk", "kernel/walk", "encode"]
    assert {s.parent for s in new[:2]} == {new[-1].id}


def test_every_kernel_wrapper_is_timed():
    """The compute spans live in the kernel wrappers, beside their
    launch counts: each of the nine is devtimer.timed."""
    from fqzcomp5_tpu_torch.ops import (model_cuda, rans_cuda, rans_cuda_bnd,
                                        rans_cuda_dec, rc_cuda)
    wrappers = [rans_cuda.encode_walk, rans_cuda_dec.decode_o0,
                rans_cuda_dec.decode_o1, rans_cuda_bnd.decode_bnd_o0,
                rans_cuda_bnd.decode_dense_o1, rc_cuda.encode_walk,
                model_cuda.evolve_128, model_cuda.evolve_256,
                model_cuda.tiny_evolve]
    for w in wrappers:
        assert w.__wrapped__.__name__ == w.__name__
        assert w.launches >= 0


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
def test_archives_identical_with_devtime_on(tmp_path, timer, monkeypatch,
                                            preset):
    """-1 and -5 archives of 300 100 bp records in 16 KB blocks: equal
    with the switch on and off, decoded to the source with it on; the
    encode and the decode each move bytes and count walks."""
    src = _fastq(tmp_path / "in.fastq", 300, seed=len(preset))
    arg, _, _ = cli.parse_args([preset, "-V"])
    arg.blk_size = 16_000
    blobs, snaps, roots = {}, {}, {}
    for on in (False, True):
        monkeypatch.setattr(timer, "enabled", on)
        timer.reset()
        n = len(timer.spans())
        out = io.BytesIO()
        cuda_driver.encode_file(str(src), out, arg, Timings(), CPU)
        blobs[on] = out.getvalue()
        snaps[on] = timer.snapshot()
        roots[on] = [s.name for s in timer.spans()[n:] if s.parent is None]
    assert blobs[True] == blobs[False]
    assert snaps[False] == ZERO
    # the spans: none with the switch off, one encode request with it on
    assert roots == {False: [], True: ["encode"]}
    assert snaps[True]["link_bytes"] > 0 and snaps[True]["compute_calls"] > 0
    timer.reset()
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(blobs[True]),
                            make_fastq_writer(out, arg), arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()
    snap = timer.snapshot()
    assert snap["link_bytes"] > 0 and snap["compute_calls"] > 0
    timer.reset()
    assert timer.snapshot() == ZERO
