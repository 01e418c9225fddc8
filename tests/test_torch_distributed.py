"""The port's multi-process encode and decode
(fqzcomp5_tpu_torch.parallel.distributed) on the CPU, over gloo.

Ranks are subprocesses of the port's entry on 127.0.0.1, each with a
time limit; if one fails or the limit passes, every rank is killed.
The host engine's archives must equal the JAX package's single-process
host encoder's, the decodes the source, and a rank that cannot run
must end with ERROR: before it joins the group.  The learner's
lock-step ticks are held against the owner's learner in-process.
The -e cuda runs are in tests/test_torch_dist_cuda.py.
"""

import gzip
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import drivers as jdrivers
from fqzcomp5_tpu.options import Options as JOptions
from fqzcomp5_tpu_torch import cli, cuda_driver, fastq
from fqzcomp5_tpu_torch.blocks import encode_block
from fqzcomp5_tpu_torch.learning import MethodLearner
from fqzcomp5_tpu_torch.options import method_avail_for
from fqzcomp5_tpu_torch.parallel import dist_cuda, distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = ["-m", "fqzcomp5_tpu_torch.parallel.distributed"]
CPU = torch.device("cpu")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(nprocs, args, env=None, timeout=240, entry=ENTRY):
    """Start nprocs ranks of `entry` with `args` (no card visible);
    returns [(rc, stdout, stderr)] by rank."""
    port = free_port()
    procs = []
    for pid in range(nprocs):
        e = dict(os.environ)
        e.pop("FQZ5_DIST_LOCAL_MESH", None)
        e.update({"FQZ5_DIST_COORD": f"127.0.0.1:{port}",
                  "FQZ5_DIST_NPROCS": str(nprocs),
                  "FQZ5_DIST_PID": str(pid),
                  "FQZ5_DIST_STATS": "1",
                  "CUDA_VISIBLE_DEVICES": "",
                  "OMP_NUM_THREADS": "2",
                  "PYTHONPATH": ROOT + os.pathsep
                  + os.environ.get("PYTHONPATH", ""),
                  **(env or {})})
        procs.append(subprocess.Popen(
            [sys.executable, *entry, *map(str, args)], env=e, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def check_ok(outs):
    for rank, (rc, _out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}: {err[-3000:]}"


def error_line(err: str) -> str:
    """The ERROR: line of a rank's stderr ("" if there is none)."""
    return next((ln for ln in err.splitlines() if ln.startswith("ERROR:")),
                "")


def rank_stats(outs):
    """Each rank's FQZ5_DIST_STATS line."""
    got = [json.loads(ln) for _rc, out, _err in outs
           for ln in out.splitlines() if ln.startswith('{"dist_stat"')]
    assert len(got) == len(outs)
    return got


def make_fastq(path, n=2000, L=90, seed=5):
    """Clean 4-line FASTQ of fixed-length reads from a random
    chromosome."""
    rng = np.random.default_rng(seed)
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30000)
    off = rng.integers(0, len(chrom) - L, n)
    q = (np.clip(rng.normal(32, 4, (n, L)), 2, 40) + 33).astype(np.uint8)
    data = b"".join(b"@blk%d\n" % i + chrom[o:o + L].tobytes() + b"\n+\n"
                    + q[i].tobytes() + b"\n" for i, o in enumerate(off))
    path.write_bytes(data)
    return data


def _jax_host_encode(src, preset, blk):
    arg = JOptions()
    arg.apply_preset(preset)
    arg.blk_size = blk
    arg.verbose = -1
    arg.nthread = 1
    ref = io.BytesIO()
    jdrivers.encode_file(str(src), ref, arg, jdrivers.Timings())
    return ref.getvalue()


@pytest.mark.parametrize("nprocs", [2, 3])
def test_host_engine_matches_single_process(tmp_path, nprocs):
    src = tmp_path / "in.fastq"
    make_fastq(src, n=3000)
    out = tmp_path / "dist.fqz5"
    outs = run_ranks(nprocs, ["-3", "-b", 64 << 10, "-e", "host", src, out])
    check_ok(outs)
    assert out.read_bytes() == _jax_host_encode(src, 3, 64 << 10)
    # parse once: each rank parses only the byte ranges it owns
    insize = os.path.getsize(src)
    st = rank_stats(outs)
    for s in st:
        assert 0 < s["parse_bytes"] <= insize / nprocs + (64 << 10), s
    assert sum(s["parse_bytes"] for s in st) == insize


def test_gzip_input(tmp_path):
    """gzip cannot be pre-split: -e host parses it on every rank
    (replicated) and writes the single-process archive; -e cuda refuses
    it on every rank with ERROR: and exit 1."""
    plain = tmp_path / "in.fastq"
    make_fastq(plain, n=1200, seed=6)
    gz = tmp_path / "in.fastq.gz"
    with gzip.open(gz, "wb") as g:
        g.write(plain.read_bytes())
    out = tmp_path / "gz.fqz5"
    outs = run_ranks(2, ["-3", "-b", 32 << 10, "-e", "host", gz, out])
    check_ok(outs)
    assert out.read_bytes() == _jax_host_encode(gz, 3, 32 << 10)
    outs = run_ranks(2, ["-1", "-b", 32 << 10, "--device", "cpu", gz,
                         tmp_path / "c.fqz5"])
    for rc, _out, err in outs:
        assert rc == 1 and "scannable" in error_line(err), err
        assert "Traceback" not in err


def test_decode_single_and_paired(tmp_path):
    src = tmp_path / "in.fastq"
    data = make_fastq(src, n=1500, seed=7)
    comp = tmp_path / "in.fqz5"
    assert cli.main(["-e", "host", "-3", "-b", str(32 << 10), "-V", str(src),
                     str(comp)]) == 0
    out = tmp_path / "dist.fastq"
    check_ok(run_ranks(2, ["-d", comp, out]))
    assert out.read_bytes() == data

    r1, r2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    make_fastq(r1, n=800, seed=8)
    make_fastq(r2, n=800, seed=9)
    pcomp = tmp_path / "p.fqz5"
    assert cli.main(["-e", "host", "-3", "-b", str(32 << 10), "-V", str(r1),
                     str(r2), str(pcomp)]) == 0
    o1, o2 = tmp_path / "o1.fastq", tmp_path / "o2.fastq"
    check_ok(run_ranks(3, ["-d", pcomp, o1, o2]))
    assert o1.read_bytes() == r1.read_bytes()
    assert o2.read_bytes() == r2.read_bytes()


@pytest.mark.parametrize("args, msg", [
    (["-1"], "needs a CUDA device"),
    (["-e", "cuda", "-5"], "needs a CUDA device"),
    (["-e", "tpu", "-1"], "JAX package's engine")])
def test_rank_that_cannot_run_ends_before_the_group(tmp_path, args, msg):
    """No card and no --device cpu (or -e tpu): every rank prints ERROR:
    and exits 1 without joining the group, so none waits on another
    (the coordinator's port has no listener), and nothing is written."""
    src = tmp_path / "in.fastq"
    make_fastq(src, n=50)
    out = tmp_path / "c.fqz5"
    outs = run_ranks(2, [*args, src, out], timeout=60)
    for rc, _out, err in outs:
        assert rc == 1 and msg in error_line(err), err
        assert "Traceback" not in err
    assert not out.exists()


def _state(learner):
    return (learner._usize, learner._csize, learner._review, learner._trial,
            learner._used)


def _blocks(tmp_path, n, L=60):
    src = tmp_path / "small.fastq"
    make_fastq(src, n=n, L=L, seed=10)
    return src


def test_tick_block_follows_the_owner_across_a_review(tmp_path):
    """The host path's lock-step: a peer learner that ticks every block
    (replaying the owner's journal for trial blocks) equals the owner's
    learner after every block, through a review re-open."""
    src = _blocks(tmp_path, 2200)
    arg, _, _ = cli.parse_args(["-5", "-V"])
    blocks = fastq.scan_blocks(str(src), 1500)
    assert len(blocks) > 104
    owner, peer = MethodLearner(), MethodLearner()
    owner.method_avail = peer.method_avail = method_avail_for(arg)
    trials = []
    for start, end, _nrec, _sb in blocks:
        trial = any(owner.in_trial(s) or owner.will_reopen(s)
                    for s in distributed._SECS)
        trials.append(trial)
        owner.start_journal()
        encode_block(owner, arg, fastq.parse_block_range(str(src), start,
                                                         end))
        journal = owner.pop_journal()
        assert bool(journal) == trial
        distributed._tick_block(peer, is_fasta=False)
        peer.replay_journal(journal)
        assert _state(peer) == _state(owner)
    # three trial blocks, locked ones, and a trial re-opened by a review
    assert trials[:4] == [True] * 3 + [False] and any(trials[4:])


@pytest.mark.parametrize("preset", ["-1", "-5"])
def test_tick_wave_follows_the_owner_across_a_review(tmp_path, preset):
    """The wave engine's lock-step: the owner encodes each wave with
    cuda_driver.encode_wave_blocks on the CPU; a peer ticks it from the
    owner's journal, or from none when _wave_needs_sync says the wave
    holds no trial.  After every wave the learners are equal."""
    src = _blocks(tmp_path, 2200)
    arg, _, _ = cli.parse_args([preset, "-V"])
    blocks = fastq.scan_blocks(str(src), 1500)
    owner, peer = MethodLearner(), MethodLearner()
    owner.method_avail = peer.method_avail = method_avail_for(arg)
    groups = cuda_driver.wave_groups_from_sizes([2 * b[3] for b in blocks])
    base = 0
    synced = []
    for g in groups:
        wave = blocks[base:base + g]
        base += g
        needs_sync = dist_cuda._wave_needs_sync(owner, len(wave))
        assert needs_sync == dist_cuda._wave_needs_sync(peer, len(wave))
        owner.start_journal()
        cuda_driver.encode_wave_blocks(
            owner, arg, [fastq.parse_block_range(str(src), b[0], b[1])
                         for b in wave], CPU)
        journal = owner.pop_journal()
        if not needs_sync:
            assert journal == []
        dist_cuda._tick_wave(peer, len(wave), journal)
        assert _state(peer) == _state(owner)
        synced.append(needs_sync)
    assert base > 104 and synced[0] and not all(synced[1:])
    # a wave after the first one re-opened the trial
    assert any(synced[1:])
