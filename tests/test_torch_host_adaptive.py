"""The host driver's per-block device route of the adaptive codecs
(``blocks.encode_block`` given a device; the CLI's ``-e host`` with
FQZ5_DEVICE_ADAPTIVE) on the CPU, where every walk runs its plain
version, against the JAX package's route (FQZ5_DEVICE_ADAPTIVE=1 under
JAX_PLATFORMS=cpu) and the native host codecs.  The tolerance is zero:
archives and payloads must be equal byte for byte.

On the CPU each section walks the plain range coder as one stream, about
80 us a step, so the inputs hold a hundred short reads or fewer in 4 KB
blocks: enough for three trial blocks and locked ones.  The archives are
encoded on one thread: with several, which blocks the learner tries
every method on depends on when the blocks in flight finish.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import blocks as jblocks
from fqzcomp5_tpu import cli as jcli
from fqzcomp5_tpu import drivers as jdrivers
from fqzcomp5_tpu.ops import fqz_device_encode as jfqz
from fqzcomp5_tpu.ops import seq_device_encode as jseq
from fqzcomp5_tpu_torch import blocks, cli, drivers, fastq
from fqzcomp5_tpu_torch.codecs import host
from fqzcomp5_tpu_torch.constants import Method
from fqzcomp5_tpu_torch.ops import (fqz_device_encode, model_cuda,
                                    rc_torch, seq_device_encode)

from tests.test_torch_distributed import check_ok, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BLK = 4_000


def _records(n, seed, fasta=False, name="S"):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGTNacgt"))
    p = [.24, .24, .24, .24, .01, .01, .01, .005, .005]
    recs = []
    for i in range(n):
        L = int(rng.integers(60, 140))
        seq = "".join(bases[rng.choice(9, L, p=p)])
        if fasta:
            recs.append(f">{name}.{i}\n{seq}\n")
            continue
        q = (np.cumsum(rng.integers(-2, 3, L)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@{name}.{i} {i}\n{seq}\n+\n{q}\n")
    return "".join(recs)


def _inputs(tmp_path, kind):
    """The input files of kind single, paired or fasta."""
    if kind == "paired":
        r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
        r1.write_text(_records(40, 7, name="P"))
        r2.write_text(_records(40, 8, name="P"))
        return [str(r1), str(r2)]
    src = tmp_path / ("in.fa" if kind == "fasta" else "in.fq")
    src.write_text(_records(120 if kind == "fasta" else 80, 5,
                            fasta=kind == "fasta"))
    return [str(src)]


def _port(files, argv, device, blk=BLK):
    arg, _, _ = cli.parse_args(argv + ["-e", "host", "-V", "-t", "1"])
    arg.blk_size = blk
    out = io.BytesIO()
    if len(files) == 2:
        drivers.encode_paired(*files, out, arg, drivers.Timings(), device)
    else:
        drivers.encode_file(files[0], out, arg, drivers.Timings(), device)
    return out.getvalue()


def _jax_route(files, argv, monkeypatch, blk=BLK):
    """The JAX package's -e host encode with FQZ5_DEVICE_ADAPTIVE=1."""
    monkeypatch.setenv("FQZ5_DEVICE_ADAPTIVE", "1")
    arg, _, _ = jcli.parse_args(argv + ["-V", "-t", "1"])
    arg.blk_size = blk
    out = io.BytesIO()
    try:
        if len(files) == 2:
            jdrivers.encode_paired(*files, out, arg, jdrivers.Timings())
        else:
            jdrivers.encode_file(files[0], out, arg, jdrivers.Timings())
    finally:
        monkeypatch.delenv("FQZ5_DEVICE_ADAPTIVE")
    return out.getvalue()


@pytest.fixture
def walks(monkeypatch):
    """Names of the plain walks the route ran."""
    calls = set()
    for mod, name in ((rc_torch, "encode_walk_ref"),
                      (model_cuda.fqz_model_torch, "evolve_ref"),
                      (model_cuda.fqz_model_torch, "tiny_evolve_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _fn=fn, _n=name, **k: calls.add(_n) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("kind", ["single", "paired", "fasta"])
@pytest.mark.parametrize("preset", [["-5"], ["-7"], []])
def test_archive_matches_jax_route(tmp_path, monkeypatch, walks, preset,
                                   kind):
    """-5, -7 and the default preset; single, paired and FASTA inputs in
    trial and locked blocks: the route's archive equals the JAX route's
    and the host codecs', and decodes to the source."""
    files = _inputs(tmp_path, kind)
    got = _port(files, preset, CPU)
    assert walks >= {"encode_walk_ref", "tiny_evolve_ref", "evolve_ref"}
    assert got == _jax_route(files, preset, monkeypatch)
    assert got == _port(files, preset, None)
    arg, _, _ = cli.parse_args(["-d", "-V"])
    outs = [io.BytesIO() for _ in files]
    writer = (drivers.make_deinterleave_writer(*outs, arg) if len(outs) == 2
              else drivers.make_fastq_writer(outs[0], arg))
    drivers.decode_file(io.BytesIO(got), writer, arg, drivers.Timings())
    for o, f in zip(outs, files):
        assert o.getvalue() == open(f, "rb").read()


def _block(tmp_path, seed=3, n=120):
    """A FastqBatch of n variable-length reads with N and lower case."""
    path = tmp_path / f"block{seed}.fq"
    path.write_text(_records(n, seed))
    return fastq.Parser(fastq.open_input(str(path))).next_batch(1 << 30)


def test_entries_match_jax_and_host(tmp_path):
    """seq_device_encode.encode_payload, fqz_device_encode.encode_payload
    and fqz_compress_device against the JAX package's and the host
    codecs'."""
    fq = _block(tmp_path)
    lens = np.asarray(fq.lens, np.uint32)
    for both, slevel in ((0, 10), (1, 12), (1, 8)):
        got = seq_device_encode.encode_payload(fq.seq_buf, lens, both,
                                               slevel, CPU)
        assert got == jseq.encode_payload(fq.seq_buf, lens, both, slevel)
        assert got == host.seq_encode(fq.seq_buf, lens, both, slevel)
    for strat, seq in ((0, None), (1, None), (3, fq.seq_buf),
                       (4, fq.seq_buf)):
        want = host.fqz_compress(fq.qual_buf, lens, fq.flags, seq, strat)
        got = fqz_device_encode.fqz_compress_device(
            fq.qual_buf, lens, fq.flags, seq, strat, CPU)
        assert got == want
        assert got == jfqz.fqz_compress_device(fq.qual_buf, lens, fq.flags,
                                               seq, strat)
        _, P, sels = fqz_device_encode.prepare_fqz(fq.qual_buf, lens,
                                                   fq.flags, seq, strat)
        pay = fqz_device_encode.encode_payload(fq.qual_buf, lens, sels, P,
                                               CPU, seq=seq)
        _, jP, jsels = jfqz.prepare_fqz(fq.qual_buf, lens, fq.flags, seq,
                                        strat)
        assert pay == jfqz.encode_payload(fq.qual_buf, lens, jsels, jP,
                                          seq=seq)
        assert want.endswith(pay) and len(pay) < len(want)


def _wide_quality_block(tmp_path):
    fq = _block(tmp_path, seed=11, n=60)
    rng = np.random.default_rng(12)
    qual = rng.integers(0, 100, len(fq.qual_buf)).astype(np.uint8)
    qual[:100] = np.arange(100)   # an alphabet of 100 symbols
    fq.qual_buf = qual.tobytes()
    return fq


def test_wide_quality_alphabet_skips_fqz(tmp_path, monkeypatch):
    """A quality alphabet of 96 symbols or more: the device entries give
    None, and the route skips the method, as the host codec and the JAX
    route do."""
    fq = _wide_quality_block(tmp_path)
    lens = np.asarray(fq.lens, np.uint32)
    assert fqz_device_encode.fqz_compress_device(
        fq.qual_buf, lens, fq.flags, None, 1, CPU) is None
    _, P, sels = fqz_device_encode.prepare_fqz(fq.qual_buf, lens, fq.flags,
                                               None, 1)
    assert fqz_device_encode.encode_payload(fq.qual_buf, lens, sels, P,
                                            CPU) is None
    arg, _, _ = cli.parse_args(["-5", "-V"])
    for m in (Method.FQZ1, Method.FQZ3):
        assert blocks._compress_one(m, arg, fq, 3, fq.qual_buf, CPU) is None
        assert blocks._compress_one(m, arg, fq, 3, fq.qual_buf) is None
        monkeypatch.setenv("FQZ5_DEVICE_ADAPTIVE", "1")
        jarg, _, _ = jcli.parse_args(["-5", "-V"])
        assert jblocks._compress_one(m, jarg, fq, 3, fq.qual_buf) is None
        monkeypatch.delenv("FQZ5_DEVICE_ADAPTIVE")


def test_seq_over_the_host_cap_is_kept(tmp_path, monkeypatch):
    """2,000 random bytes code to more than the host codec's cap of len +
    100: the host route skips SEQ10, the device route keeps the payload,
    as the JAX route does."""
    fq = _block(tmp_path, seed=13, n=20)
    rng = np.random.default_rng(14)
    fq.seq_buf = rng.integers(0, 256, 2000).astype(np.uint8).tobytes()
    fq.lens = np.full(20, 100, np.uint32)
    arg, _, _ = cli.parse_args(["-5", "-V"])
    assert blocks._compress_one(Method.SEQ10, arg, fq, 2, fq.seq_buf) is None
    got = blocks._compress_one(Method.SEQ10, arg, fq, 2, fq.seq_buf, CPU)
    assert got is not None and len(got[0]) > len(fq.seq_buf) + 100
    monkeypatch.setenv("FQZ5_DEVICE_ADAPTIVE", "1")
    jarg, _, _ = jcli.parse_args(["-5", "-V"])
    assert jblocks._compress_one(Method.SEQ10, jarg, fq, 2,
                                 fq.seq_buf) == got
    assert host.seq_decode(got[0], fq.lens, 0, 10,
                           len(fq.seq_buf)) == fq.seq_buf


def _tampered(fn):
    def bad(*a, **k):
        out = fn(*a, **k)
        if out is None:
            return None
        k = len(out) // 2
        return out[:k] + bytes([out[k] ^ 0x5A]) + out[k + 1:]
    return bad


@pytest.mark.parametrize("entry", ["seq", "fqz"])
def test_verify_switch_catches_a_bad_payload(tmp_path, monkeypatch, entry,
                                             capsys):
    """FQZ5_DEVICE_ADAPTIVE_VERIFY: a device payload that does not decode
    back raises ValueError; through the CLI (its card lookup given the
    CPU), ERROR: and exit 1.  Without the switch the payload is used."""
    src = tmp_path / "in.fq"
    src.write_text(_records(60, 21))
    mod, name = ((seq_device_encode, "encode_payload") if entry == "seq"
                 else (fqz_device_encode, "fqz_compress_device"))
    monkeypatch.setattr(mod, name, _tampered(getattr(mod, name)))
    arg, _, _ = cli.parse_args(["-5", "-V"])
    _port([str(src)], ["-5"], CPU)   # no check: the bad payload is kept
    arg.verify_device = 1
    with pytest.raises(ValueError, match="failed native decode-back"):
        drivers.encode_file(str(src), io.BytesIO(), arg, drivers.Timings(),
                            CPU)
    monkeypatch.setattr(cli, "_cuda_device", lambda what: CPU)
    monkeypatch.setenv("FQZ5_DEVICE_ADAPTIVE", "1")
    monkeypatch.setenv("FQZ5_DEVICE_ADAPTIVE_VERIFY", "1")
    assert cli.main(["-e", "host", "-5", "-V", str(src),
                     str(tmp_path / "c.fqz5")]) == 1
    assert "failed native decode-back" in capsys.readouterr().err


def test_device_error_propagates(tmp_path, monkeypatch):
    """A device error reaches the caller: the port's route has no
    fallback to the host codecs (the JAX route falls back with a
    warning)."""
    src = tmp_path / "in.fq"
    src.write_text(_records(60, 22))

    def broken(*a, **k):
        raise RuntimeError("injected device error")
    monkeypatch.setattr(model_cuda, "tiny_evolve", broken)
    with pytest.raises(RuntimeError, match="injected device error"):
        _port([str(src)], ["-5"], CPU)
    monkeypatch.setattr(jseq, "encode_payload", broken)
    assert _jax_route([str(src)], ["-5"], monkeypatch) == _port(
        [str(src)], ["-5"], None)


def test_cli_switch_without_a_card_fails_and_writes_nothing(tmp_path):
    """-e host with FQZ5_DEVICE_ADAPTIVE and no visible card: ERROR:,
    exit 1, no output file; its decode needs no card."""
    src = tmp_path / "in.fq"
    src.write_text(_records(40, 23))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", FQZ5_DEVICE_ADAPTIVE="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    comp = tmp_path / "c.fqz5"
    r = subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "-e",
                        "host", "-5", str(src), str(comp)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert r.stderr.startswith("ERROR:") and "FQZ5_DEVICE_ADAPTIVE" in r.stderr
    assert "Traceback" not in r.stderr
    assert not comp.exists()
    assert cli.main(["-e", "host", "-5", "-V", str(src), str(comp)]) == 0
    out = tmp_path / "o.fq"
    r = subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "-e",
                        "host", "-d", str(comp), str(out)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == src.read_bytes()


def test_host_ranks_with_the_switch_equal_one_process(tmp_path):
    """Two ranks of the distributed entry, -e host --device cpu with
    FQZ5_DEVICE_ADAPTIVE: the archive equals one process's route."""
    src = tmp_path / "in.fq"
    src.write_text(_records(400, 24))
    comp = tmp_path / "c.fqz5"
    check_ok(run_ranks(2, ["-5", "-b", BLK, "-e", "host", "--device", "cpu",
                           src, comp], env={"FQZ5_DEVICE_ADAPTIVE": "1"}))
    assert comp.read_bytes() == _port([str(src)], ["-5"], CPU)


def test_concurrent_route_calls_equal_the_host_codecs(tmp_path):
    """Four threads send blocks through the route at once, as the host
    driver's pool does: every payload equals the host codec's."""
    from concurrent.futures import ThreadPoolExecutor

    fqs = [_block(tmp_path, seed=30 + k, n=30) for k in range(4)]

    def run(fq):
        return (seq_device_encode.encode_payload(fq.seq_buf, fq.lens, 1, 12,
                                                 CPU),
                fqz_device_encode.fqz_compress_device(
                    fq.qual_buf, fq.lens, fq.flags, fq.seq_buf, 3, CPU))
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(run, fqs))
    for fq, (seq, qual) in zip(fqs, got):
        assert seq == host.seq_encode(fq.seq_buf, fq.lens, 1, 12)
        assert qual == host.fqz_compress(fq.qual_buf, fq.lens, fq.flags,
                                         fq.seq_buf, 3)
