"""-5 on reads of varying length through the port's wave engine on the CPU
(its plain walks): fixed and ragged reads, with full qualities and with
qualities binned to eight levels (few enough symbols that the fqz
parameter picker stores a quality map).  Each archive is the JAX
engine's, byte for byte, round-trips, and the benchmark's plain
reference (gpubench/gbench) reads every block of it correct.  With
FQZ5_DEVTIME on, pass 1 counts the cells of the planes it walks
(pass1_cells), the symbols they hold (pass1_symbols) and the FQZ
stream's length events (len_events)."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import cli as jax_cli, tpu_driver
from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch.ops import adaptive_batch, devtimer

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "gpubench"))
try:
    from gbench import control, ref_archive
finally:
    sys.path.remove(os.path.join(ROOT, "gpubench"))


def _reads(n, ragged, binned, seed=17):
    """n reads of 101 bases, or of 25-400; qualities a random walk in
    Phred 2-40, or that binned to eight levels."""
    rng = np.random.default_rng(seed)
    lens = (rng.integers(25, 401, n) if ragged
            else np.full(n, 101)).astype(np.int64)
    L = int(lens.max())
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, L))]
    walk = np.cumsum(rng.integers(-2, 3, (n, L)), axis=1)
    qual = (np.abs(walk + 30) % 39 + 2 + 33).astype(np.uint8)
    if binned:
        qual = control.bin_quals(qual)
    names = [b"R.%d %d/1" % (i + 1, i + 1) for i in range(n)]
    return ref_archive.Reads(names, seq, qual, lens)


def _fastq(r):
    return b"".join(b"@%s\n%s\n+\n%s\n" % (r.names[k], r.seq[k, :m].tobytes(),
                                            r.qual[k, :m].tobytes())
                    for k, m in enumerate(r.lens.tolist()))


def _encode(tmp_path, reads):
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(reads))
    arg, _, _ = cli.parse_args(["-5", "-V"])
    blob = io.BytesIO()
    cuda_driver.encode_file(str(src), blob, arg, Timings(), CPU)
    return src, arg, blob.getvalue()


@pytest.mark.parametrize("binned", [False, True], ids=["full", "binned"])
@pytest.mark.parametrize("ragged", [False, True], ids=["101bp", "ragged"])
def test_round_trip_and_reference(tmp_path, ragged, binned):
    """Binned qualities in ragged reads once raised IndexError: pass 1
    padded the quality plane with 0, which a stored quality map does not
    map, and the padded entries then indexed past the model's table."""
    reads = _reads(48 if ragged else 90, ragged, binned)
    src, arg, archive = _encode(tmp_path, reads)
    jax_arg, _, _ = jax_cli.parse_args(["-5", "-V"])
    jax_out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), jax_out, jax_arg, Timings())
    assert archive == jax_out.getvalue()
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(archive), make_fastq_writer(out, arg),
                            arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()
    rep = ref_archive.check(archive, reads)
    assert rep.bad_blocks == 0, rep.first_error
    assert rep.blocks >= 1 and rep.records == len(reads)


@pytest.fixture
def on(monkeypatch):
    """devtimer enabled, with an empty span log of its own, and the
    lengths of every job pass 1 runs."""
    monkeypatch.setattr(devtimer, "enabled", True)
    monkeypatch.setattr(devtimer, "_log",
                        type(devtimer._log)(maxlen=devtimer.MAX_SPANS))
    jobs = []
    prep = adaptive_batch._prep_job

    def seen(job, device):
        out = prep(job, device)
        if out is not None:
            jobs.append((job[0], np.asarray(job[2], np.int64)))
        return out
    monkeypatch.setattr(adaptive_batch, "_prep_job", seen)
    yield jobs
    devtimer.reset()


def _counts():
    roots = [s for s in devtimer.spans() if s.parent is None]
    assert [r.name for r in roots] == ["encode"]
    return roots[0].counts


def test_ragged_counters(tmp_path, on):
    _encode(tmp_path, _reads(48, ragged=True, binned=False))
    c = _counts()
    assert on and {kind for kind, _ in on} >= {"seq", "fqz"}
    assert c["pass1_cells"] == sum(len(lens) * int(lens.max())
                                   for _, lens in on)
    assert c["pass1_symbols"] == sum(int(lens.sum()) for _, lens in on)
    assert c["pass1_cells"] > c["pass1_symbols"]
    # lengths vary, so every record emits its four length events
    fqz = [lens for kind, lens in on if kind == "fqz"]
    assert c["len_events"] == sum(4 * len(lens) for lens in fqz)
    assert c["len_events"] <= c["pass2_events"]


def test_fixed_length_counters(tmp_path, on):
    _encode(tmp_path, _reads(90, ragged=False, binned=False))
    c = _counts()
    assert on
    assert c["pass1_cells"] == c["pass1_symbols"] == sum(
        int(lens.sum()) for _, lens in on)
    # one length for the block: only the first record emits it
    assert c["len_events"] == 4 * sum(kind == "fqz" for kind, _ in on)
    assert c["len_events"] <= c["pass2_events"]
