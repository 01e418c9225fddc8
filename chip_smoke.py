#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (fqzcomp5_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:
  1. device  -- requires torch.cuda; prints the card's name and power
     limit as nvidia-smi reports them.
  2. build   -- builds the native host library and the CUDA kernels
     from the checkout's sources (nvcc, sm_90a, one process per source).
  3. kernels -- runs each of the nine kernels and its plain PyTorch
     version on the same inputs and requires bit-identical results (the
     tolerance is zero: this is integer entropy coding); times both on
     the card with CUDA events, beside the launch's bound.  rANS: 64
     streams, 4096 steps, order-0 and order-1 at shift 10 and 12, ragged
     lengths, a single-symbol stream; the boundary-table walks at S = 16
     and 48 (packed) and 256 (counter) and dense order-1 tables of 6 and
     47 symbols at shift 10 and 12, with single-symbol streams and
     contexts; then the five JAX-signature functions of
     ops/rans_bnd_dec.py on the card against the CPU on one small input.
     The order-1 decode walk's route edges: alphabets just under and
     just over the shared-memory fit of its compact tables at shift 10
     and 12 and a full byte alphabet, each also with word rows cut
     short.  The dense order-1
     walk on tests/test_torch_dense_walk.py's cases (built by
     tests/torch_cases.py, as are all the cases the CPU tests share;
     DENSE_CASES: shift 10 and 12, A = 6 to 140 with byte 0 a symbol or
     not, the shared-memory fit at each shift, packed and counter tables,
     single-symbol contexts; each round-tripped, with ragged lengths and
     one 0, with word rows cut short and with the boundaries of half its
     rows out of order; and tables built from s3 LUTs as the engine
     builds them); the order-0 walk on four streams with
     ragged lengths and rows cut short, and at B = 200.  The order-0
     boundary walk on tests/test_torch_bnd_o0_walk.py's cases
     (BND_O0_CASES: packed S = 16 and 64, counter S = 16 and 256, shift
     10 and 12; each round-tripped, with ragged lengths and one 0, with
     rows cut short and with tables no encoder makes: rows below tot,
     boundaries out of order, inconsistent F fields, random entries, f0 =
     0 and tot), and at B = 200 with packed and counter tables.  Model evolution:
     65,536 contexts x 4,096 occurrences at 128 slots, 4 x 4,096 at 256
     slots, 2^20 TinyModels x 256; at 128 slots, in both layouts, a
     ladder of runs that moves symbols across every lane boundary, zipf
     symbols past the halving bound, max_sym 1, 96 and 128, and a long
     context; the TinyModel walk in both layouts and the 256-slot walk on
     window edge cases (halvings at every lane of a window, rows ending
     inside one, symbols past nsym, runs of the symbol in slot 0 broken
     at lanes 0, 1 and 31 and halving inside, max_sym 129 and 256,
     uniform symbols) and on the -5 path's longest rows (2 x 318,825
     TinyModel steps, 2 x 187,545 run-length steps).  Range coder: 16
     streams x 4,096 steps in two chunks with the state carried, and 2
     streams whose first holds an 0xFF run of thousands of bytes (longer
     than the kernel's shared-memory ring of flush records) deferred
     across the chunk boundary.  Then the decode walks of --walk-times at
     the main path's launch shapes: decode_o1 and decode_dense_o1,
     decode_o0 and decode_bnd_o0, each round-tripped and timed.  (The
     other walks of --walk-times, model evolution, range coder and encode
     walk, assert nothing and run only there.)
  4. adaptive -- encodes the seq and qual of the first 10 MB block of a
     FASTQ corpus (made with seeded numpy before phase 3: 150 bp reads,
     random-walk qualities) under SEQ10, SEQ12B, FQZ1 and FQZ3 as one
     batch on the card; the payloads must equal the native host codecs'.
  5. e2e     -- drives the port's CLI (fqzcomp5_tpu_torch.cli, whose
     default engine is the card) at -1 and -3 on the whole corpus and
     at -5 on its first 128 MB (E2E_ADAPTIVE_MB), each path with every
     launch count set to 0 just before it and read just after: encode,
     decode, cmp; decodes the same archives with the host engine
     (-e host).  At -1 and -3 the archive is decoded once more with
     FQZ5_DEC_V3=1 (the boundary-table kernels), again with the counts
     set to 0 before and read after.  Every kernel a path runs must have
     launched in it (the encode walk at every preset, the four adaptive
     kernels at -5, each rANS decoder the decode path handed a batch,
     the boundary order-0 walk at -1 and the dense order-1 walk at -3).
     Reports each path's peak device memory, and encodes a 4 MB prefix at -1
     and a 1 MB prefix at -5 both on the card and on the CPU (plain
     versions; in subprocesses started before phase 3, which run beside
     the card's phases), requiring equal archives.
  6. host-adaptive -- the host engine's per-block device route: the CLI's
     -e host -5 with FQZ5_DEVICE_ADAPTIVE=1 on the corpus's first 50 MB
     (one block: four one-job batches of about 24 MB) and on a 16 MB
     prefix at -b 1000000 (16 blocks, trial and locked, the driver's 4
     threads calling the route at once).  Each archive must equal the
     native -e host encode of its prefix (in subprocesses started before
     phase 3); evolve_128, evolve_256, tiny_evolve and rc_encode_walk
     must launch and encode_walk must not; the 50 MB archive is decoded
     with -e host and must equal its prefix.  Logs each run's wall, MB/s
     and peak device memory beside the native run's wall.
  7. daemon  -- the port's daemon, served by a subprocess of this script
     (--daemon-serve) whose server must have loaded the kernel library
     and left CUDA uninitialised: the corpus at -1 through it (cmp with
     the e2e archive), its -d (cmp with the source), both again through
     the C client (bin/fqz5-torch, built at its first use into
     build/fqz5_torch_client/; the decode must launch decode_o0 and
     decode_o1), and -d with FQZ5_DEC_V3=1 forwarded; a -1 encode of a
     4 MB prefix and a decode at once, each equal to its direct run;
     five -1 encodes of the prefix each through the C client,
     daemon.request and as fresh processes, and five requests that fail
     at once (no CUDA context) through the C client and through the
     Python launcher, each wall logged.  Then a -5 encode of the corpus through
     the C client, whose client is killed once the job's CUDA context
     shows in nvidia-smi: within 15 s the job must be gone from /proc
     and its context from nvidia-smi, and its output must stop growing;
     the server must then answer ping and encode the prefix again
     through the C client (cmp).  Every forked child records its launch
     counts, which must show its path's kernels, and its first CUDA
     call's time.
  7b. devtime -- FQZ5_DEVTIME=1 in-process: the corpus at -1 (encode,
     decode) and a 1 MB prefix at -5, each archive cmp-equal to its run
     without the switch; logs link_s, link_bytes, compute_s,
     compute_calls and the wall, with compute_calls > 0 and, on the
     corpus, link_bytes at least its seq+qual bytes.
  8. scale   -- the scale-out paths (fqzcomp5_tpu_torch.parallel) on a
     mesh of every visible card, or of cuda:0 twice (1 x 2, its ranges one
     after another) when one is visible: the corpus at -1 over the mesh
     (cmp with the e2e phase's -1 archive), that archive decoded over the
     mesh with both table forms (cmp with the source), and an 8 MB prefix
     at -5 -b 250000 (about 32 blocks, two waves) over the mesh and on
     cuda:0 alone (cmp).  Then two ranks of the port's distributed entry on
     127.0.0.1 over gloo, -e cuda, each on cuda:{rank % cards}, started
     through --dist-rank: the corpus at -1 (cmp with the e2e archive; the
     ranks' parse bytes sum to at most the file + 1 KB), the prefix at -5
     with a 1x2 local mesh a rank (FQZ5_DIST_LOCAL_MESH; cmp with the
     cuda:0 archive), and -d of the -1 archive (cmp with the source).
     Every run sets the counts to 0 before it and requires its kernels
     after it, the ranks' counts included (at -5, rank 0 owns the wave
     of trial blocks and must launch all five kernels of the path; the
     later wave runs the locked methods only, so rank 1 must launch
     some); wall seconds and MB/s are
     logged, one card's numbers when one card is visible.
  9. corrupt -- 8 seeded mutations each of a -1 and a -3 archive (byte
     stomps that reach the rANS payloads, an absurd output size,
     truncations), each decoded through the CLI on the card with both
     table forms in a subprocess of its own: each must exit 0, or 1 with
     ERROR: and no traceback, within its time limit.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.  A launch's bound is the benchmark's
(gpubench/gbench/roofline.py): the larger of its bytes, counted from the
algorithm (each symbol once, plus the compressed bytes or model steps
written or read), over the card's memory rate and its integer operations
over its int32 rate; a kernel's bound_ms is the mean over its timed
cases.  library_ms is null, as no PyTorch call computes an entropy
coder's walk.  The port's speed is gpubench/run.py's to measure
(--trace 1 for where the time goes), not this script's.

    python3 chip_smoke.py --only PHASE[,PHASE...]    (--scale: --only scale)

builds the kernels, makes the same corpus, encodes it at -1 through the
CLI and runs only the named phases of host-adaptive, daemon, devtime and
scale
(the scale phase on a mesh of every visible card, for a host with
several).

    python3 chip_smoke.py --timed-cli ARGS...
    python3 chip_smoke.py --daemon-serve SOCK DIR

run the port's CLI and print its seconds (the host-adaptive phase's
native encodes), and serve the port's daemon with each child's launch
counts written under DIR (the daemon phase's server).

    python3 chip_smoke.py --dist-rank ARGS...

runs one rank of fqzcomp5_tpu_torch.parallel.distributed with ARGS
(FQZ5_DIST_* in the environment) and prints its kernels' launch counts
as one JSON line: the scale phase's ranks.

    python3 chip_smoke.py --walk-times [--decode] [--root DIR]

only times the redesigned walks alone at the main path's shapes (the
range coder, the rANS encode walk, the order-1 decode walks over s3 and
over dense tables, the order-0 decode walks over s3 and over boundary
tables, evolve_128, the TinyModel walk, evolve_256), with cycles a step
and their bounds; with --decode only the decode walks.
--root DIR (default: this checkout) times the fqzcomp5_tpu_torch of the
checkout at DIR, e.g. an unpacked parent commit, so that two versions
are compared on one card in one call.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(ROOT, "gpubench"))

from gbench import roofline  # noqa: E402
from tests import torch_cases  # noqa: E402

CORPUS_MB = 256
SEED = torch_cases.SEED
B_STREAMS = 64
T_STEPS = 4096
# (preset, kernels its encode always launches)
PATHS = (("-1", ("encode_walk",)), ("-3", ("encode_walk",)),
         ("-5", ("encode_walk", "evolve_128", "evolve_256", "tiny_evolve",
                 "rc_encode_walk")))
# the e2e phase's -5 run: the corpus's first E2E_ADAPTIVE_MB MB (its
# 256 MB at 0.85 MB/s took 308 s, and with it the whole smoke reached its
# 1,200 s limit on a slower card machine)
E2E_ADAPTIVE_MB = 128
# (preset, prefix MB) encoded on the card and on the CPU, and the CPU
# encodes' limit
PREFIXES = (("-1", 4), ("-5", 1))
CPU_ENCODE_TIMEOUT_S = 900
# presets whose archive is decoded again through the boundary-table
# walks, and the kernel each such decode must launch
BOUNDARY = {"-1": "decode_bnd_o0", "-3": "decode_dense_o1"}
# the scale phase: the -5 prefix (MB) and its block size (32 blocks, two
# waves; at this size the whole smoke, host-adaptive and daemon phases
# included, stays inside its time limit), and each distributed rank's
# limit
SCALE_PREFIX_MB = 8
SCALE_BLK = 250_000
DIST_TIMEOUT_S = 600
# host-adaptive phase: (run, prefix MB, extra CLI arguments) of -e host -5
# with FQZ5_DEVICE_ADAPTIVE=1: one -5 block (50 MB, half a whole one, so
# that the smoke stays inside its time limit); 16 blocks of 1 MB
HOST_ADAPTIVE_RUNS = (("50 MB", 50, []),
                      ("16 MB -b 1000000", 16, ["-b", "1000000"]))
ADAPTIVE_KERNELS = ("evolve_128", "evolve_256", "tiny_evolve",
                    "rc_encode_walk")
# daemon phase: the prefix of its concurrent and start-up requests
DAEMON_PREFIX_MB = 4
STARTUP_RUNS = 5
# the C client (bin/fqz5-torch), built by the script into this directory
CLIENT = os.path.join("bin", "fqz5-torch")
CLIENT_EXE = os.path.join("build", "fqz5_torch_client", "fqz5-torch")
# a cancelled job: seconds to wait for its CUDA context, and for the job
# and its context to be gone after its client is killed
CANCEL_START_S = 120
CANCEL_GONE_S = 15
# corrupt archives a preset in the corrupt phase, and each decode's limit
CORRUPT_SEEDS = 8
CORRUPT_TIMEOUT_S = 300
# flush records the range-coder kernel's shared-memory ring holds
# (csrc/rc_encode.cu: kStages x kRecords)
RC_RING_RECORDS = 4 * 256
CLOCK_HZ = 1.98e9         # H100 SXM boost clock, for cycles a step
SMS = 132                 # H100 SXM streaming multiprocessors
# max_abs_err of the kernels' edge cases (check()), by kernel
EDGE_ERRS: dict = {}
# (B streams, T steps a lane, shift, symbols, quality-like random walk or
# uniform symbols) of the order-1 decode walks (decode_o1, and
# decode_dense_o1 on the same streams) timed by --walk-times: the -3 and
# -1 decode launches' shapes on the corpus (PERF.md's kernel table, rows 3
# and 7; their quality streams: 40 symbols, and byte 0, 41 codes in
# decode_o1's tables), and -1's with 100 uniform symbols
# (the dense tables' counter form; the most words a step from the ring)
WALK_DECODE_O1 = ((6, 1_494_492, 10, 40, True), (16, 149_925, 10, 40, True),
                  (9, 149_925, 10, 40, True), (16, 149_925, 10, 100, False))
# (B streams, T steps a lane, alphabet) of the order-0 decode walks timed
# by --walk-times: the -1 decode launches' shapes (rows 2 and 6; their
# reads' bases), and -1's with uniform bytes (8 bits a symbol: half the
# lanes renormalise each step)
WALK_DECODE_O0 = ((16, 149_925, b"ACGT"), (9, 149_925, b"ACGT"),
                  (16, 149_925, bytes(range(256))))
# (C contexts, T steps, max_sym) of evolve_128 timed by --walk-times: -5
# count buckets (row 9: short, the largest, and one of long contexts) and
# one long context
WALK_EVOLVE_128 = ((40385, 1024, 96), (41535, 4096, 96), (36, 469_362, 96),
                   (1, 100_000, 96))
# (C contexts, T steps, nsym) of the TinyModel walk timed by --walk-times:
# the nine launches of -5's largest batch of seq jobs (PERF.md's kernel
# table, row 11): the read-start k-mer contexts (one context a job with an
# occurrence a read, 4 with a quarter as many, ...) and the bulk of the
# contexts at T = 16 to 256
WALK_TINY = ((2, 318_825, 4), (16, 262_144, 4), (64, 65_536, 4),
             (256, 16_384, 4), (1_024, 4_096, 4), (4_086, 1_024, 4),
             (260_281, 256, 4), (3_735_416, 64, 4), (2_294_569, 16, 4))
# (label, C, T) of the 256-slot walk timed by --walk-times: -5's run-length
# rows (symbol 255 in runs; its longest launch) and a row of uniform
# symbols
WALK_EVOLVE_256 = (("run-length", 2, 187_545), ("uniform", 1, 100_000))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"[phase] {name}: {time.monotonic() - t0:.3f} s")


# ---------------------------------------------------------------------
# phase 3 inputs: synthetic streams and their coder tables

def _streams(rng, np):
    """64 byte streams of ragged lengths (at most T_STEPS*32 bytes):
    DNA-like, random-walk qualities, uniform bytes, and one
    single-symbol stream."""
    out = []
    cap = T_STEPS * 32
    for b in range(B_STREAMS):
        n = cap if b == 0 else int(rng.integers(cap // 2, cap + 1))
        kind = b % 3
        if b == 5:
            d = np.full(n, 67, np.uint8)
        elif kind == 0:
            d = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                           p=[0.3, 0.2, 0.2, 0.29, 0.01])
        elif kind == 1:
            steps = rng.integers(-2, 3, n)
            d = (np.cumsum(steps) % 40 + 36).astype(np.uint8)
        else:
            d = rng.integers(0, 256, n).astype(np.uint8)
        out.append(d.astype(np.uint8))
    return out


def _cu_const(name: str) -> int:
    """An integer constexpr of csrc/fqz_evolve.cu, e.g. the context count
    from which a layout is picked."""
    import re

    with open(os.path.join(ROOT, "fqzcomp5_tpu_torch", "csrc",
                           "fqz_evolve.cu")) as fp:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             fp.read()).group(1))


def _time(fn, reps: int):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps, out


def _max_err(xs, ys) -> int:
    import torch

    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def _work(walk: str, args, result, coded: int = 0) -> tuple[int, int]:
    """(symbols, bytes) of one launch of walk, counted by gpubench's rule
    (gbench/roofline.work: from the algorithm, not from the tensors'
    sizes); coded: a decode's compressed bytes read, the words of the
    rows its case built."""
    syms, other = roofline.work(walk, args, result)
    syms = int(syms)
    return syms, syms + (coded if other is None else int(other))


def _bound(walk: str, syms: int, nbytes: int):
    """(ms, "bytes" or "operations"): gpubench's least time for a walk of
    this work (gbench/roofline.least_seconds), and which term sets it."""
    tb = roofline.least_seconds(0, nbytes, walk)
    to = roofline.least_seconds(syms, 0, walk)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _record(res: dict, name: str, label: str, err: int, k_ms: float,
            p_ms: float, work, note: str = "") -> None:
    """Logs one timed case of kernel name against its plain version and
    keeps it in res[name] for the last JSON line; any difference fails
    the smoke."""
    b_ms, by = _bound(name, *work)
    res.setdefault(name, []).append((label, err, k_ms, p_ms, b_ms, by))
    log(f"  {name} {label}: max_abs_err {err}  kernel {k_ms:.3f} ms "
        f"({work[0] / k_ms / 1e3:.3f} M symbols/s)  plain {p_ms:.3f} ms  "
        f"bound {b_ms:.4f} ms ({by})" + note)
    if err:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             "version")


def kernels_vs_plain(np, torch, dev):
    from fqzcomp5_tpu_torch import engine_cuda
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_cuda_dec, rans_torch

    rng = np.random.default_rng(SEED)
    datas = _streams(rng, np)
    lens = np.array([len(d) for d in datas], np.int32)
    B, T = B_STREAMS, T_STEPS
    res = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compact(Rf, words, nw):
        """(final states, word rows, the rows' bytes) of an encode."""
        Rf = Rf.cpu().numpy().view(np.uint32)
        w = words.cpu().numpy().view(np.uint16)
        nw = nw.cpu().numpy()
        rows = [w[b, w.shape[1] - nw[b]:] for b in range(B)]
        Wmax = max(1, max(len(r) for r in rows))
        wr = np.zeros((B, Wmax), np.uint16)
        for b, r in enumerate(rows):
            wr[b, :len(r)] = r
        return Rf, wr, 2 * int(nw.sum())

    def check_enc(label, args):
        k_ms, k_out = _time(lambda: rans_cuda.encode_walk(*args), 5)
        p_ms, p_out = _time(lambda: rans_torch.encode_walk_ref(*args), 1)
        nk, npl = k_out[2], p_out[2]
        err = _max_err([k_out[0], nk], [p_out[0], npl])
        cap = T * 32
        for b in range(B):
            n = int(nk[b])
            err = max(err, _max_err([k_out[1][b, cap - n:]],
                                    [p_out[1][b, cap - n:]]))
        _record(res, "encode_walk", label, err, k_ms, p_ms,
                _work("encode_walk", args, k_out))
        return k_out

    # order-0: uint8 plane + symbol counts, native prep tables
    plane = np.zeros((B, T * 32), np.uint8)
    freqs0 = np.empty((B, 256), np.uint32)
    for b, d in enumerate(datas):
        plane[b, :len(d)] = d
        freqs0[b] = engine_cuda.o0_prep(d.tobytes())[1]
    tab0 = rans_torch.tables_from_numpy(freqs0, "freqs", shift=12,
                                        device=dev)
    enc0 = check_enc("o0 shift12", (put(plane.reshape(B, T, 32)), tab0, 12,
                                    None, put(lens)))
    Rf0, w0, coded = compact(*enc0)
    s3_0 = rans_torch.tables_from_numpy(rans_torch.build_s3(freqs0, 12),
                                        "s3", device=dev)
    args = (put(w0.view(np.int16)), put(Rf0.view(np.int32)), s3_0,
            put(lens // 32), T)
    k_ms, k_out = _time(lambda: rans_cuda_dec.decode_o0(*args), 5)
    p_ms, p_out = _time(lambda: rans_torch.decode_o0_ref(*args), 1)
    err = _max_err(k_out, p_out)
    syms = k_out[0].cpu().numpy()
    for b, d in enumerate(datas):
        t = len(d) // 32
        if not np.array_equal(syms[b, :t].reshape(-1), d[:t * 32]):
            raise AssertionError(f"decode_o0: stream {b} does not round-trip")
    _record(res, "decode_o0", "shift12", err, k_ms, p_ms,
            _work("decode_o0", args, k_out, coded),
            "  (round-trips the sources)")

    # order-1: flat ctx*256+sym plane, per-chunk layout, lane 31 seeded
    iszs = lens // 32
    flat = np.full((B, T, 32), 256 * 256, np.int32)
    counts = np.zeros((B, 256 * 256), np.int64)
    for b, d in enumerate(datas):
        isz = int(iszs[b])
        ch = d[:32 * isz].reshape(32, isz).T.astype(np.int32)
        f = np.empty((isz, 32), np.int32)
        f[0] = ch[0]
        f[1:] = ch[:-1] * 256 + ch[1:]
        flat[b, :isz] = f
        counts[b] = np.bincount(f.reshape(-1), minlength=256 * 256)
    R0 = np.full((B, 32), rans_torch.RANS_L, np.uint32)
    R0[:, 31] = rng.integers(1 << 15, 1 << 31, B)
    for shift in (10, 12):
        fr = torch_cases.normalise(counts.reshape(B, 256, 256), shift)
        tab1 = rans_torch.tables_from_numpy(fr, "freqs", shift=shift,
                                            device=dev)
        enc1 = check_enc(f"o1 shift{shift}", (put(flat), tab1, shift,
                                              put(R0.view(np.int32))))
        Rf1, w1, coded = compact(*enc1)
        s3_1 = rans_torch.tables_from_numpy(
            rans_torch.build_s3(fr, shift).reshape(B, -1), "s3",
            device=dev)
        args = (put(w1.view(np.int16)), put(Rf1.view(np.int32)), s3_1,
                put(iszs.astype(np.int32)), T, shift)
        k_ms, k_out = _time(lambda: rans_cuda_dec.decode_o1(*args), 5)
        p_ms, p_out = _time(lambda: rans_torch.decode_o1_ref(*args), 1)
        err = _max_err(k_out, p_out)
        syms = k_out[0].cpu().numpy()
        for b, d in enumerate(datas):
            isz = int(iszs[b])
            if not np.array_equal(syms[b, :isz].T.reshape(-1),
                                  d[:32 * isz]):
                raise AssertionError(
                    f"decode_o1 shift{shift}: stream {b} does not "
                    "round-trip")
        _record(res, "decode_o1", f"shift{shift}", err, k_ms, p_ms,
                _work("decode_o1", args, k_out, coded),
                "  (round-trips the sources)")
    return res


def adaptive_kernels_vs_plain(np, torch, dev):
    """The model-evolution and range-coder kernels against their plain
    versions (zero tolerance)."""
    from fqzcomp5_tpu_torch.ops import (fqz_model_torch, model_cuda,
                                        rc_cuda, rc_torch)

    rng = np.random.default_rng(SEED + 1)
    res = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def model_case(C, T, max_sym):
        counts = rng.integers(1, T + 1, C).astype(np.int32)
        counts[0] = T
        ms = rng.integers(2, max_sym + 1, C).astype(np.int32)
        ms[0] = max_sym
        z = rng.zipf(1.3, (C, T))
        sp = np.minimum(z - 1, ms[:, None] - 1).astype(np.uint8)
        sp[1] = ms[1] - 1
        return put(sp), put(counts), put(ms)

    for name, fn, cap, (C, T, M) in (
            ("evolve_128", model_cuda.evolve_128, 128, (65536, 4096, 96)),
            ("evolve_256", model_cuda.evolve_256, 256, (4, 4096, 256))):
        sp, ct, ms = model_case(C, T, M)
        k_ms, k_out = _time(lambda: fn(sp, ct, ms), 3)
        p_ms, p_out = _time(
            lambda: fqz_model_torch.evolve_ref(sp, ct, ms, cap), 1)
        _record(res, name, f"C={C} T={T}", _max_err(k_out, p_out), k_ms,
                p_ms, _work(name, (sp, ct, ms), k_out))
    evolve_edge_cases(np, torch, dev, rng)
    window_edge_cases(np, torch, dev)
    for nsym in (4, 2):
        C, T = 1 << 20, 256
        counts = put(rng.integers(0, T + 1, C).astype(np.int32))
        sp = put(rng.integers(0, nsym, (C, T)).astype(np.uint8))
        k_ms, k_out = _time(
            lambda: model_cuda.tiny_evolve(sp, counts, nsym), 3)
        p_ms, p_out = _time(
            lambda: fqz_model_torch.tiny_evolve_ref(sp, counts, nsym), 1)
        _record(res, "tiny_evolve", f"nsym={nsym} C={C} T={T}",
                _max_err(k_out, p_out), k_ms, p_ms,
                _work("tiny_evolve", (sp, counts, nsym), k_out))

    def rc_case(label, cum, freq, tot, lens, chunk):
        """B streams of up to T steps walked in chunks of `chunk` steps
        with the state carried, kernel against plain at every chunk.
        Returns the kernel's bytes of every stream and the deferred run
        length (ffnum) of every stream after each chunk."""
        B, T = tot.shape
        cf = put(((cum << 16) | freq).astype(np.uint32).view(np.int32)
                 .reshape(-1))
        tt = put(tot.astype(np.int32).reshape(-1))
        st_k = st_p = rc_torch.init_state(B, dev)
        err = 0
        k_tot = p_tot = 0.0
        work = [0, 0]
        outs = [[] for _ in range(B)]
        ffs = []
        for t0 in range(0, T, chunk):
            n = put(np.clip(lens - t0, 0, chunk).astype(np.int32))
            off = put(np.arange(B, dtype=np.int64) * T + np.minimum(t0, lens))
            cap = rc_torch.cap_for(chunk, int(st_k[3].max()))
            st_in = st_k
            k_ms, k_out = _time(
                lambda: rc_cuda.encode_walk(cf, tt, off, n, st_in, cap), 3)
            p_ms, p_out = _time(lambda: rc_torch.encode_walk_ref(
                cf, tt, off, n, st_p, cap), 1)
            w = _work("rc_encode_walk", (cf, tt, off, n, st_in, cap), k_out)
            work = [a + b for a, b in zip(work, w)]
            err = max(err, _max_err(k_out[1:], p_out[1:]))
            totals = k_out[1].cpu().numpy()
            for b in range(B):
                nb = int(totals[b])
                err = max(err, _max_err([k_out[0][b, :nb]],
                                        [p_out[0][b, :nb]]))
                outs[b].append(k_out[0][b, :nb].cpu().numpy())
            st_k, st_p = k_out[2], p_out[2]
            ffs.append(st_k[3].cpu().numpy())
            k_tot += k_ms
            p_tot += p_ms
        outs = [np.concatenate(o) for o in outs]
        _record(res, "rc_encode_walk", label, err, k_tot, p_tot, work)
        return outs, ffs

    # range coder: 16 ragged streams of up to 4096 steps, two chunks
    B, T, chunk = 16, 4096, 2048
    tot = rng.integers(2, 65519, (B, T))
    freq = np.minimum(rng.integers(1, 65519, (B, T)), tot)
    cum = (rng.random((B, T)) * (tot - freq + 1)).astype(np.int64)
    # least-probable top symbols of a power-of-two total
    tot[3], freq[3], cum[3] = 1 << 15, 1, (1 << 15) - 1
    tot[4] = rng.integers(2, 300, T)            # TinyModel-like totals
    freq[4] = np.maximum(1, tot[4] // 3)
    cum[4] = 0
    lens = rng.integers(0, T + 1, B)
    lens[:5] = T
    rc_case(f"B={B} T={T} in 2 chunks", cum, freq, tot, lens, chunk)

    # a deferred 0xFF run longer than the kernel's shared-memory ring of
    # flush records, deferred across the chunk boundary and flushed in
    # the second launch
    cum, freq, tot = torch_cases.straddle_streams(rng, 2, T, 500, 3500)
    outs, ffs = rc_case(f"B=2 T={T} in 2 chunks, long 0xFF run", cum, freq,
                        tot, np.full(2, T), chunk)
    run = torch_cases.longest_run(outs[0], 0xFF)
    if run <= RC_RING_RECORDS or ffs[0][0] <= 0:
        raise AssertionError(
            f"rc_encode_walk: the longest 0xFF run is {run} bytes (ring "
            f"{RC_RING_RECORDS}), {ffs[0][0]} deferred at the chunk boundary")
    log(f"  rc_encode_walk long-run case: a run of {run} 0xFF bytes, "
        f"{ffs[0][0]} of them deferred across the chunk boundary")
    return res


def _o1_walk_case(B, T, shift, A, g, np, torch, dev, walk=True):
    """B order-1 streams of T steps a lane at `shift`, each lane a random
    walk (steps -2..2) over A quality-like symbols from 33, as the
    corpus's qualities are, or (walk=False) uniform over bytes 1..A:
    encoded on the card by the encode walk.  Returns (decode_o1
    arguments, the symbols (B, T, 32) uint8, the frequencies (B, 256,
    256), the word rows' bytes)."""
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_torch

    if walk:
        step = torch.randint(-2, 3, (B, T, 32), device=dev,
                             dtype=torch.int16, generator=g)
        sym = (step.cumsum(1, dtype=torch.int32) % A + 33).to(torch.int32)
        del step
    else:
        sym = torch.randint(1, A + 1, (B, T, 32), device=dev,
                            dtype=torch.int32, generator=g)
        sym[:, 0] = torch.arange(32, device=dev) % A + 1
        sym[:, 1:A // 32 + 3] = (torch.arange(32 * (A // 32 + 2), device=dev)
                                 .view(-1, 32) % A + 1)
    flat = sym.clone()
    flat[:, 1:] += sym[:, :-1] * 256      # context: the lane's last symbol
    counts = torch.stack([torch.bincount(flat[b].view(-1), minlength=65536)
                          for b in range(B)]).cpu().numpy()
    freqs = torch_cases.normalise(counts.reshape(B, 256, 256), shift)
    Rf, w, nw = rans_cuda.encode_walk(
        flat, rans_torch.tables_from_numpy(freqs, "freqs", shift=shift,
                                           device=dev), shift)
    del flat
    nw = nw.cpu().numpy()
    cap = w.shape[1]
    words = torch.zeros((B, max(1, int(nw.max()))), dtype=torch.int16,
                        device=dev)
    for b, n in enumerate(nw):
        words[b, :n] = w[b, cap - n:]
    del w
    s3 = rans_torch.tables_from_numpy(
        rans_torch.build_s3(freqs, shift).reshape(B, -1), "s3", device=dev)
    t_real = torch.full((B,), T, dtype=torch.int32, device=dev)
    return ((words, Rf, s3, t_real, T, shift), sym.to(torch.uint8), freqs,
            2 * int(nw.sum()))


def _o0_walk_case(B, T, g, np, torch, dev, alphabet=b"ACGT"):
    """B order-0 streams of T steps a lane uniform over alphabet (DNA
    bases: -1's order-0 streams are its reads' bases), encoded on the card
    by the encode walk.  Returns (decode_o0 arguments, the symbols (B, T, 32)
    uint8, the frequencies (B, 256), the word rows' bytes)."""
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_torch

    alpha = torch.tensor(list(alphabet), dtype=torch.uint8, device=dev)
    sym = alpha[torch.randint(0, len(alphabet), (B, T, 32), device=dev,
                              generator=g)]
    counts = torch.stack([torch.bincount(sym[b].view(-1).to(torch.int64),
                                         minlength=256)
                          for b in range(B)]).cpu().numpy()
    freqs = torch_cases.normalise(counts, 12)
    Rf, w, nw = rans_cuda.encode_walk(
        sym, rans_torch.tables_from_numpy(freqs, "freqs", shift=12,
                                          device=dev), 12,
        nsym=torch.full((B,), T * 32, dtype=torch.int32, device=dev))
    nw = nw.cpu().numpy()
    cap = w.shape[1]
    words = torch.zeros((B, max(1, int(nw.max()))), dtype=torch.int16,
                        device=dev)
    for b, n in enumerate(nw):
        words[b, :n] = w[b, cap - n:]
    del w
    s3 = rans_torch.tables_from_numpy(rans_torch.build_s3(freqs, 12), "s3",
                                      device=dev)
    t_real = torch.full((B,), T, dtype=torch.int32, device=dev)
    return (words, Rf, s3, t_real, T), sym, freqs, 2 * int(nw.sum())


def check(name: str, label: str, got, want) -> None:
    """Kernel result against its plain version, zero tolerance; kept in
    EDGE_ERRS for the kernel's max_abs_err."""
    err = _max_err(got, want)
    EDGE_ERRS.setdefault(name, []).append(err)
    log(f"  {name} {label}: max_abs_err {err}")
    if err:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             "version")


def evolve_edge_cases(np, torch, dev, rng) -> None:
    """evolve_128 in both layouts (one warp a context below
    csrc/fqz_evolve.cu's kThreadLayoutMinC contexts, one thread a context
    from it) against evolve_ref: a ladder of runs (every symbol climbs
    the bubble order across every lane boundary; many halvings), zipf
    symbols past the halving bound, max_sym 1, 96 and 128, and a long
    context."""
    from fqzcomp5_tpu_torch.ops import fqz_model_torch, model_cuda

    ladder = np.concatenate([np.full(130 + i, 127 - i) for i in range(128)])
    cases = [("ladder C=1", ladder[None, :], [len(ladder)], [128]),
             ("long context C=1 T=20000",
              np.minimum(rng.zipf(1.3, (1, 20000)) - 1, 95), [20000], [96])]
    for C, T in ((4, 6000), (2048, 4600)):
        z = np.minimum(rng.zipf(1.2, (C, T)) - 1, 127)
        counts = rng.integers(T // 2, T + 1, C)
        ms = np.resize([1, 96, 128], C)
        cases.append((f"C={C} T={T} max_sym 1/96/128", z, counts, ms))
    for label, sp, counts, ms in cases:
        ms = np.asarray(ms, np.int32)
        sp = np.minimum(sp, ms[:, None] - 1).astype(np.uint8)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (sp, np.asarray(counts, np.int32), ms)]
        check("evolve_128", label, model_cuda.evolve_128(*args),
              fqz_model_torch.evolve_ref(*args, 128))


# the main path's longest pass-2 rows at -5 (100 MB blocks of 150 bp
# reads, a SEQ10 and a SEQ12B job a batch; PERF.md's kernel table, rows
# 11 and 12): the TinyModel context every read starts in (one occurrence a
# read), and the run-length model of the base class (runs cross records,
# cut into chunks of 255)
LONG_TINY_T = 318_825
LONG_RUN_T = 187_545


def window_edge_cases(np, torch, dev) -> None:
    """The TinyModel walks and the 256-slot walk against their plain
    versions, zero tolerance, on the cases of torch_cases.tiny_window_cases
    and run_window_cases: each case alone (the warp layouts), the TinyModel
    cases of each nsym tiled past csrc/fqz_evolve.cu's kTinyThreadMinC
    contexts (the thread layout), and the main path's longest rows, C = 2
    x LONG_TINY_T random bases and C = 2 x LONG_RUN_T of symbol 255 (the
    plain versions of these two on the CPU, where a step costs less than
    a string of kernel launches)."""
    from fqzcomp5_tpu_torch.ops import fqz_model_torch, model_cuda

    def put(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    tiled = {4: [], 2: []}
    for name, (sp, counts, nsym) in torch_cases.tiny_window_cases().items():
        args = put(sp.astype(np.uint8), counts.astype(np.int32))
        check("tiny_evolve", f"{name} C={sp.shape[0]}",
              model_cuda.tiny_evolve(*args, nsym),
              fqz_model_torch.tiny_evolve_ref(*args, nsym))
        tiled[nsym].append((sp, counts))
    rows = _cu_const("kTinyThreadMinC")
    for nsym, parts in tiled.items():
        T = max(sp.shape[1] for sp, _ in parts)
        sp = np.concatenate([np.pad(a, ((0, 0), (0, T - a.shape[1])))
                             for a, _ in parts])
        ct = np.concatenate([c for _, c in parts])
        reps = -(-rows // len(ct))
        args = put(np.tile(sp, (reps, 1)).astype(np.uint8),
                   np.tile(ct, reps).astype(np.int32))
        check("tiny_evolve", f"nsym={nsym} cases tiled C={len(ct) * reps}",
              model_cuda.tiny_evolve(*args, nsym),
              fqz_model_torch.tiny_evolve_ref(*args, nsym))
    for name, (sp, counts, ms) in torch_cases.run_window_cases().items():
        args = put(sp.astype(np.uint8), counts.astype(np.int32),
                   ms.astype(np.int32))
        check("evolve_256", f"{name} C={sp.shape[0]}",
              model_cuda.evolve_256(*args),
              fqz_model_torch.evolve_ref(*args, 256))
    rng = np.random.default_rng(SEED + 5)
    sp = rng.integers(0, 4, (2, LONG_TINY_T)).astype(np.uint8)
    ct = np.array([LONG_TINY_T, LONG_TINY_T - 1000], np.int32)
    t1 = time.monotonic()
    want = fqz_model_torch.tiny_evolve_ref(*(torch.from_numpy(a) for a in
                                             (sp, ct)), 4)
    cpu_s = time.monotonic() - t1
    check("tiny_evolve", f"long row C=2 T={LONG_TINY_T} (plain on the CPU, "
          f"{cpu_s:.1f} s)", [g.cpu() for g in
                              model_cuda.tiny_evolve(*put(sp, ct), 4)], want)
    # the run-length row: 255-chunks, a short chunk where a run ends
    sp = np.full((2, LONG_RUN_T), 255, np.uint8)
    sp[0, rng.integers(300, LONG_RUN_T, 20)] = rng.integers(0, 255, 20)
    ct = np.array([LONG_RUN_T, LONG_RUN_T - 77], np.int32)
    ms = np.full(2, 256, np.int32)
    t1 = time.monotonic()
    want = fqz_model_torch.evolve_ref(*(torch.from_numpy(a) for a in
                                        (sp, ct, ms)), 256)
    cpu_s = time.monotonic() - t1
    check("evolve_256", f"run-length row C=2 T={LONG_RUN_T} (plain on the "
          f"CPU, {cpu_s:.1f} s)", [g.cpu() for g in
                                   model_cuda.evolve_256(*put(sp, ct, ms))],
          want)


def decode_o1_edge_cases(np, torch, dev) -> None:
    """decode_o1 against decode_o1_ref where csrc/rans_decode.cu changes
    route: alphabets (byte 0 counted) just under and just over the
    shared-memory fit of its compact tables at shifts 10 and 12, and a
    full byte alphabet (the s3 route); each also with its word rows cut
    to a quarter, so that lanes read past a row's end.  (The B = 64 case
    holds a single-symbol stream, single-symbol contexts at shift 12 and
    streams that wrap the kernel's 2,048-word ring many times.)"""
    from fqzcomp5_tpu_torch.ops import rans_cuda_dec, rans_torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    for shift, A, route in ((12, 51, "shared"), (12, 52, "global"),
                            (10, 140, "shared"), (10, 141, "global"),
                            (12, 256, "s3")):
        args, sym, *_ = _o1_walk_case(8, 1024, shift, A - 1, g, np, torch,
                                      dev, walk=False)
        s3 = args[2].cpu().numpy().view(np.uint32)
        tabs = [rans_torch.o1_compact_tables(r, shift) for r in s3]
        if {(len(t[0]), t[1]) for t in tabs} != {(A, route)}:
            raise AssertionError(f"decode_o1 case A={A} shift{shift} is not "
                                 f"on the {route} route")
        got = rans_cuda_dec.decode_o1(*args)
        if not torch.equal(got[0], sym):
            raise AssertionError(f"decode_o1 A={A} shift{shift}: the "
                                 "symbols do not round-trip")
        check("decode_o1", f"A={A} shift{shift} {route} (round-trips)", got,
              rans_torch.decode_o1_ref(*args))
        cut = (args[0][:, :max(1, args[0].shape[1] // 4)].contiguous(),
               *args[1:])
        check("decode_o1", f"A={A} shift{shift} {route} rows cut short",
              rans_cuda_dec.decode_o1(*cut), rans_torch.decode_o1_ref(*cut))


def dense_o0_edge_cases(np, torch, dev) -> None:
    """decode_dense_o1 and decode_o0 against their plain versions, zero
    tolerance, on tests/test_torch_dense_walk.py's cases (torch_cases:
    dense_case, DENSE_CASES, o0_case): each dense case round-trips, then
    runs with ragged lengths (one 0), with its word rows cut to a quarter
    and with the boundaries of half its rows out of order
    (scramble_boundaries; against the numpy mirror, and in the packed form
    against the plain version too); tables as the engine builds them at
    shift 12 (single-symbol contexts wrapped
    in s3, byte 0 from the contexts that never occur); the order-0 cases
    with ragged lengths and rows cut short; and decode_o0 at B = 200
    (more streams than SMs: several blocks share an SM)."""
    from fqzcomp5_tpu_torch.ops import (rans_bnd_torch, rans_cuda_bnd,
                                        rans_cuda_dec, rans_torch)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    T = torch_cases.EDGE_T
    full = np.full(3, T, np.int32)
    ragged = np.array([T, 17, 0], np.int32)

    def dense(label, words, R0, tab, shift, A, A1, last0, sym):
        for what, w, tr in (("round-trips", words, full),
                            ("ragged, one empty", words, ragged),
                            ("rows cut short",
                             words[:, :max(1, words.shape[1] // 4)], full)):
            args = (put(w), put(R0), put(tab), put(tr), T, shift, A, A1,
                    last0)
            got = rans_cuda_bnd.decode_dense_o1(*args)
            if what == "round-trips" and not np.array_equal(
                    got[0].cpu().numpy(), sym):
                raise AssertionError(f"decode_dense_o1 {label}: the "
                                     "symbols do not round-trip")
            check("decode_dense_o1", f"{label} {what}", got,
                  rans_bnd_torch.decode_dense_o1_ref(*args))
        # rows whose boundaries do not rise: the kernel against its numpy
        # mirror (every slot written, none read out of bounds) and, in the
        # packed form, where the two agree on any boundaries, against the
        # plain version
        bad = torch_cases.scramble_boundaries(
            np.random.default_rng(A1 + shift), tab, A, A1)
        args = (put(words), put(R0), put(bad), put(full), T, shift, A, A1,
                last0)
        got = rans_cuda_bnd.decode_dense_o1(*args)
        mir = rans_bnd_torch.decode_dense_compact(words, R0, bad, full, T,
                                                  shift, A, A1, last0)
        check("decode_dense_o1", f"{label} boundaries out of order "
              "(numpy mirror)", got,
              [put(mir[0]), put(mir[1].view(np.int32)), put(mir[2])])
        if A <= rans_bnd_torch.DENSE_MAX_A:
            check("decode_dense_o1", f"{label} boundaries out of order",
                  got, rans_bnd_torch.decode_dense_o1_ref(*args))

    for shift, A, zero, route in torch_cases.DENSE_CASES:
        rng = np.random.default_rng(1000 * shift + A)
        words, R0, tab, A1, last0, sym, _ = torch_cases.dense_case(
            rng, A, shift, zero)
        if rans_bnd_torch.dense_route(A, shift) != route:
            raise AssertionError(f"dense case A={A} shift{shift} is not on "
                                 f"the {route} route")
        dense(f"A={A} A1={A1} shift{shift} {route}", words, R0, tab, shift,
              A, A1, last0, sym)
    words, R0, _, _, _, sym, freqs = torch_cases.dense_case(
        np.random.default_rng(12), 5, 12, False)
    tab, _, A, A1, last0 = rans_bnd_torch.build_o1_dense_tables(
        rans_bnd_torch.freqs_from_s3(rans_torch.build_s3(freqs, 12)
                                     .reshape(3, -1), 12), 12)
    dense(f"engine tables A={A} A1={A1} shift12", words, R0, tab, 12, A, A1,
          last0, sym + 1)

    words, R0, s3, plane = torch_cases.o0_case(np.random.default_rng(7))
    t_real = np.array([T, 13, 0, T - 1], np.int32)
    for what, w in (("ragged, one empty", words),
                    ("rows cut short", words[:, :max(1, words.shape[1] // 4)])):
        args = (put(w), put(R0), put(s3), put(t_real), T)
        got = rans_cuda_dec.decode_o0(*args)
        if w is words and not np.array_equal(got[0][0].cpu().numpy(),
                                             plane[0]):
            raise AssertionError("decode_o0: stream 0 does not round-trip")
        check("decode_o0", f"cases of 4 streams {what}", got,
              rans_torch.decode_o0_ref(*args))
    rng = np.random.default_rng(SEED + 6)
    cap = T_STEPS * 32
    datas = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                        int(rng.integers(1, cap + 1))) for _ in range(200)]
    datas[7] = datas[7][:20]
    freqs, words, R0, _, lens = _o0_words(datas, dev, np, torch)
    args = (words, R0, rans_torch.tables_from_numpy(
        rans_torch.build_s3(freqs, 12), "s3", device=dev), put(lens // 32),
        T_STEPS)
    got = rans_cuda_dec.decode_o0(*args)
    syms = got[0].cpu().numpy()
    for b, d in enumerate(datas):
        t = len(d) // 32
        if not np.array_equal(syms[b, :t].reshape(-1), d[:t * 32]):
            raise AssertionError(f"decode_o0 B=200: stream {b} does not "
                                 "round-trip")
    check("decode_o0", "B=200 x T=4096 ragged, one empty (round-trips)", got,
          rans_torch.decode_o0_ref(*args))


def bnd_o0_edge_cases(np, torch, dev) -> None:
    """decode_bnd_o0 against decode_bnd_o0_ref, zero tolerance, on
    tests/test_torch_bnd_o0_walk.py's cases (torch_cases: bnd_o0_case,
    BND_O0_CASES, bnd_o0_variants): each case round-trips (a
    single-symbol stream, f0 = tot, among them), then runs with ragged
    lengths (one 0), with its word rows cut to a quarter and with each
    table of BND_O0_VARIANTS (rows below tot, boundaries out of order,
    inconsistent F fields, random entries, f0 = 0 and tot); then at B =
    200 (more streams than SMs: several blocks share an SM) with packed
    and counter tables as the engine builds them, round-tripping."""
    from fqzcomp5_tpu_torch.ops import (rans_bnd_torch, rans_cuda_bnd,
                                        rans_torch)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    T = torch_cases.EDGE_T
    full = np.full(4, T, np.int32)
    ragged = np.array([T, 17, 0, T - 1], np.int32)
    for shift, S, packed in torch_cases.BND_O0_CASES:
        rng = np.random.default_rng(1000 * shift + S + packed)
        words, R0, tab, f0, plane, freqs = torch_cases.bnd_o0_case(
            rng, S, shift, packed)
        runs = [("round-trips", words, tab, f0, full),
                ("ragged, one empty", words, tab, f0, ragged),
                ("rows cut short", words[:, :max(1, words.shape[1] // 4)],
                 tab, f0, full)]
        runs += [(what, words, t, f, full) for what, t, f in
                 torch_cases.bnd_o0_variants(rng, freqs, tab, S, shift,
                                             packed)]
        for what, w, t, f, tr in runs:
            args = (put(w), put(R0), put(t), put(f), put(tr), T, S)
            got = rans_cuda_bnd.decode_bnd_o0(*args, packed=packed,
                                              shift=shift)
            label = (f"S={S} {'packed' if packed else 'counter'} "
                     f"shift{shift} {what}")
            if what == "round-trips" and not np.array_equal(
                    got[0].cpu().numpy(), plane):
                raise AssertionError(f"decode_bnd_o0 {label}: the symbols "
                                     "do not round-trip")
            check("decode_bnd_o0", label, got,
                  rans_bnd_torch.decode_bnd_o0_ref(*args, packed=packed,
                                                   shift=shift))
    rng = np.random.default_rng(SEED + 7)
    cap = T_STEPS * 32
    for alphabet, want_S in ((np.frombuffer(b"ACGT", np.uint8), 256),
                             (np.arange(2, 40, dtype=np.uint8), 40)):
        datas = [rng.choice(alphabet, int(rng.integers(1, cap + 1)))
                 for _ in range(200)]
        datas[7] = datas[7][:20]
        freqs, words, R0, _, lens = _o0_words(datas, dev, np, torch)
        tab, f0, S, packed = rans_bnd_torch.o0_tables(
            rans_torch.build_s3(freqs, 12))
        if S != want_S:
            raise AssertionError(f"decode_bnd_o0 B=200: bucket {S}, not "
                                 f"{want_S}")
        args = (words, R0, put(tab), put(f0), put(lens // 32), T_STEPS, S)
        got = rans_cuda_bnd.decode_bnd_o0(*args, packed=packed)
        syms = got[0].cpu().numpy()
        for b, d in enumerate(datas):
            t = len(d) // 32
            if not np.array_equal(syms[b, :t].reshape(-1), d[:t * 32]):
                raise AssertionError(f"decode_bnd_o0 B=200 S={S}: stream {b} "
                                     "does not round-trip")
        check("decode_bnd_o0", f"B=200 x T=4096 S={S} "
              f"{'packed' if packed else 'counter'} ragged, one empty "
              "(round-trips)", got,
              rans_bnd_torch.decode_bnd_o0_ref(*args, packed=packed))


def walk_times(np, torch, dev, decode_only: bool = False) -> None:
    """The hand-redesigned walks alone, one launch each, at the main
    path's shapes: the range coder at B = 12 x T = 2^24 and at the -5 e2e
    launch shape B = 2 x T = 2^22 (CHUNK_T), the rANS encode walk at B = 4
    x T = 2^20 order-0 (uint8 plane) and order-1 (flat int32 plane) at
    shift 12, the order-1 decode walks (decode_o1 and decode_dense_o1 on
    the same streams) at the -3 and -1 launch shapes and on uniform
    symbols (WALK_DECODE_O1), the order-0 decode walks (decode_o0 and
    decode_bnd_o0, and a one-step launch of the latter: its prologue) at
    the -1 launch shapes on bases and on uniform bytes (WALK_DECODE_O0),
    the 128-slot model evolution at -5's bucket
    shapes (WALK_EVOLVE_128), the TinyModel walk at -5's bucket shapes
    (WALK_TINY) and the 256-slot walk on -5's run-length rows and on
    uniform symbols (WALK_EVOLVE_256).  Uses only the wrappers'
    interfaces, so it times any version of the package (--walk-times
    --root DIR); decode_only (--walk-times --decode) stops after the
    decode walks."""
    from fqzcomp5_tpu_torch.ops import (model_cuda, rans_bnd_torch,
                                        rans_cuda, rans_cuda_bnd,
                                        rans_cuda_dec, rans_torch, rc_cuda,
                                        rc_torch)

    def show(name, label, ms, T, work):
        b_ms, by = _bound(name, *work)
        log(f"  walk {name} {label}: {ms:.3f} ms ({T / ms / 1e3:.3f} M "
            f"steps/s a stream, {ms * 1e-3 * CLOCK_HZ / T:.1f} cycles a step "
            f"at {CLOCK_HZ / 1e9:.2f} GHz)  bound {b_ms:.4f} ms ({by})")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    for B, T, shift, A, walk in WALK_DECODE_O1:
        args, sym, freqs, coded = _o1_walk_case(B, T, shift, A, g, np,
                                                torch, dev, walk)
        kind = "" if walk else " uniform"
        k_ms, out = _time(lambda: rans_cuda_dec.decode_o1(*args), 1)
        if not torch.equal(out[0], sym):
            raise AssertionError(f"decode_o1 B={B} T={T} shift{shift}: the "
                                 "symbols do not round-trip")
        show("decode_o1", f"B={B} T={T} shift{shift} A={A}{kind}", k_ms, T,
             _work("decode_o1", args, out, coded))
        del out
        # the same streams through the dense tables (A symbols, byte 0
        # not among them: A1 = A + 1)
        tab, alpha, A, A1, last0 = rans_bnd_torch.build_o1_dense_tables(
            freqs, shift)
        dargs = (*args[:2], torch.from_numpy(tab).to(dev), *args[3:], A, A1,
                 last0)
        k_ms, out = _time(lambda: rans_cuda_bnd.decode_dense_o1(*dargs), 1)
        alpha = torch.from_numpy(alpha.astype(np.uint8)).to(dev)
        if not torch.equal(alpha[out[0].to(torch.int64)], sym):
            raise AssertionError(f"decode_dense_o1 B={B} T={T} shift{shift}: "
                                 "the symbols do not round-trip")
        show("decode_dense_o1", f"B={B} T={T} shift{shift} A={A} A1={A1}"
             f"{kind}", k_ms, T, _work("decode_dense_o1", dargs, out, coded))
        del args, dargs, sym, out
    for B, T, alphabet in WALK_DECODE_O0:
        args, sym, freqs, coded = _o0_walk_case(B, T, g, np, torch, dev,
                                                alphabet)
        kind = "ACGT" if alphabet == b"ACGT" else "uniform bytes"
        k_ms, out = _time(lambda: rans_cuda_dec.decode_o0(*args), 1)
        if not torch.equal(out[0], sym):
            raise AssertionError(f"decode_o0 B={B} T={T}: the symbols do not "
                                 "round-trip")
        show("decode_o0", f"B={B} T={T} {kind}", k_ms, T,
             _work("decode_o0", args, out, coded))
        # the same streams through the boundary tables, as -1's
        # FQZ5_DEC_V3 decode builds them (S = 256, the counter form)
        tab, f0, S, packed = rans_bnd_torch.o0_tables(
            rans_torch.build_s3(freqs, 12))
        bargs = (*args[:2], torch.from_numpy(tab).to(dev),
                 torch.from_numpy(f0).to(dev), *args[3:], S)
        k_ms, out = _time(lambda: rans_cuda_bnd.decode_bnd_o0(
            *bargs, packed=packed), 1)
        if not torch.equal(out[0], sym):
            raise AssertionError(f"decode_bnd_o0 B={B} T={T}: the symbols do "
                                 "not round-trip")
        show("decode_bnd_o0", f"B={B} T={T} {kind} S={S} "
             f"{'packed' if packed else 'counter'}", k_ms, T,
             _work("decode_bnd_o0", bargs, out, coded))
        # a launch's fixed cost (its prologue): one step a stream
        one = (*bargs[:4], torch.ones_like(bargs[4]), 1, S)
        p_ms, _ = _time(lambda: rans_cuda_bnd.decode_bnd_o0(
            *one, packed=packed), 5)
        log(f"  walk decode_bnd_o0 B={B} {kind} S={S}: a launch of one step "
            f"{p_ms:.4f} ms ({100 * p_ms / k_ms:.2f}% of the walk's)")
        del args, bargs, sym, out
    if decode_only:
        return

    def show_evolve(name, label, ms, args):
        counts = args[1].cpu()
        steps, T = int(counts.sum()), int(counts.max())
        b_ms, by = _bound(name, *_work(name, args, None))
        log(f"  walk {name} {label}: {ms:.3f} ms ({steps / ms / 1e3:.3f} M "
            f"steps/s; {ms * 1e-3 * CLOCK_HZ * SMS / steps:.1f} SM-cycles a "
            f"step, {ms * 1e-3 * CLOCK_HZ / T:.1f} cycles a step of the "
            f"longest context)  bound {b_ms:.4f} ms ({by})")

    rng = np.random.default_rng(SEED)
    for C, T, M in WALK_EVOLVE_128:
        counts = np.full(C, T, np.int32) if C == 1 else \
            rng.integers(1, T + 1, C).astype(np.int32)
        sp = np.minimum(rng.zipf(1.3, (C, T)) - 1, M - 1).astype(np.uint8)
        args = [torch.from_numpy(a).to(dev) for a in
                (sp, counts, np.full(C, M, np.int32))]
        k_ms, _ = _time(lambda: model_cuda.evolve_128(*args), 3)
        show_evolve("evolve_128", f"C={C} T={T} max_sym={M}", k_ms, args)
    for C, T, nsym in WALK_TINY:
        # a count bucket holds the counts in (T/4, T], the first 1..16
        counts = np.full(C, T, np.int32) if C <= 2 else \
            rng.integers(T // 4 + 1 if T > 16 else 1, T + 1, C).astype(
                np.int32)
        counts[0] = T
        sp = torch.randint(0, nsym, (C, T), device=dev, dtype=torch.uint8,
                           generator=g)
        ct = torch.from_numpy(counts).to(dev)
        k_ms, _ = _time(lambda: model_cuda.tiny_evolve(sp, ct, nsym), 3)
        show_evolve("tiny_evolve", f"C={C} T={T} nsym={nsym}", k_ms,
                    (sp, ct, nsym))
        del sp
    for label, C, T in WALK_EVOLVE_256:
        counts = np.full(C, T, np.int32)
        if label == "uniform":
            sp = rng.integers(0, 256, (C, T)).astype(np.uint8)
        else:
            # a block's bases are one class run, cut into 255-chunks
            # and a last short one
            sp = np.full((C, T), 255, np.uint8)
            sp[:, -1] = 17
        args = [torch.from_numpy(a).to(dev) for a in
                (sp, counts, np.full(C, 256, np.int32))]
        k_ms, _ = _time(lambda: model_cuda.evolve_256(*args), 3)
        show_evolve("evolve_256", f"{label} C={C} T={T}", k_ms, args)
    for B, T in ((12, 1 << 24), (2, 1 << 22)):
        tot = torch.randint(2, 65519, (B * T,), device=dev, dtype=torch.int32,
                            generator=g)
        freq = torch.minimum(torch.randint(1, 65519, (B * T,), device=dev,
                                           dtype=torch.int32, generator=g),
                             tot)
        cum = (torch.rand(B * T, device=dev, generator=g)
               * (tot - freq + 1)).to(torch.int32)
        cf = (cum << 16) | freq
        del cum, freq
        off = torch.arange(B, device=dev, dtype=torch.int64) * T
        n = torch.full((B,), T, device=dev, dtype=torch.int32)
        st = rc_torch.init_state(B, dev)
        cap = rc_torch.cap_for(T, 0)
        k_ms, out = _time(
            lambda: rc_cuda.encode_walk(cf, tot, off, n, st, cap), 1)
        show("rc_encode_walk", f"B={B} T={T}", k_ms, T,
             _work("rc_encode_walk", (cf, tot, off, n, st, cap), out))
        del cf, tot
    # 40-symbol alphabets (quality-like), every symbol and pair coded
    B, T, A = 4, 1 << 20, 40
    f0 = np.zeros((B, 256), np.int64)
    f0[:, 33:33 + A] = 1
    f1 = np.zeros((B, 256, 256), np.int64)
    f1[:, 33:33 + A, 33:33 + A] = 1
    sym = torch.randint(33, 33 + A, (B, T, 32), device=dev, dtype=torch.uint8,
                        generator=g)
    ctx = torch.randint(33, 33 + A, (B, T, 32), device=dev,
                        dtype=torch.int32, generator=g)
    flat = ctx * 256 + sym.to(torch.int32)
    del ctx
    nsym = torch.full((B,), T * 32, device=dev, dtype=torch.int32)
    for label, args in (
            ("o0 u8 shift12", (sym, rans_torch.tables_from_numpy(
                torch_cases.normalise(f0, 12), "freqs", shift=12,
                device=dev), 12, None, nsym)),
            ("o1 flat shift12", (flat, rans_torch.tables_from_numpy(
                torch_cases.normalise(f1, 12), "freqs", shift=12,
                device=dev), 12))):
        k_ms, out = _time(lambda: rans_cuda.encode_walk(*args), 1)
        show("encode_walk", f"{label} B={B} T={T}", k_ms, T,
             _work("encode_walk", args, out))


def _o0_words(datas, dev, np, torch):
    """Order-0 walks of byte streams through the encode kernel: (freqs
    (B, 256), words (B, W) int16 tensor, R0 (B, 32) int32 tensor, the
    words' bytes, lens)."""
    from fqzcomp5_tpu_torch import engine_cuda
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_torch

    B, T = len(datas), T_STEPS
    lens = np.array([len(d) for d in datas], np.int32)
    plane = np.zeros((B, T * 32), np.uint8)
    freqs = np.empty((B, 256), np.uint32)
    for b, d in enumerate(datas):
        plane[b, :len(d)] = d
        freqs[b] = engine_cuda.o0_prep(d.tobytes())[1]
    Rf, w, nw = rans_cuda.encode_walk(
        torch.from_numpy(plane.reshape(B, T, 32)).to(dev),
        rans_torch.tables_from_numpy(freqs, "freqs", shift=12, device=dev),
        12, nsym=torch.from_numpy(lens).to(dev))
    return freqs, *_compact_words(Rf, w, nw, dev, np, torch), lens


def _o1_words(datas, shift, dev, np, torch):
    """Order-1 chunked walks (lane z owns bytes [z*isz, (z+1)*isz)) of
    byte streams through the encode kernel at the given shift: (freqs
    (B, 256, 256), words, R0, the words' bytes, iszs)."""
    from fqzcomp5_tpu_torch.ops import rans_cuda, rans_torch

    B, T = len(datas), T_STEPS
    iszs = np.array([len(d) // 32 for d in datas], np.int32)
    flat = np.full((B, T, 32), 256 * 256, np.int32)
    counts = np.zeros((B, 256 * 256), np.int64)
    for b, d in enumerate(datas):
        isz = int(iszs[b])
        ch = d[:32 * isz].reshape(32, isz).T.astype(np.int32)
        flat[b, 0] = ch[0]
        flat[b, 1:isz] = ch[:-1] * 256 + ch[1:]
        counts[b] = np.bincount(flat[b, :isz].reshape(-1), minlength=65536)
    freqs = torch_cases.normalise(counts.reshape(B, 256, 256), shift)
    Rf, w, nw = rans_cuda.encode_walk(
        torch.from_numpy(flat).to(dev),
        rans_torch.tables_from_numpy(freqs, "freqs", shift=shift,
                                     device=dev), shift)
    return freqs, *_compact_words(Rf, w, nw, dev, np, torch), iszs


def _compact_words(Rf, w, nw, dev, np, torch):
    """An encode walk's (Rf, words, nwords) -> (words (B, W) int16, R0
    (B, 32) int32) on dev, the rows a decode walk reads, and their words'
    bytes."""
    w = w.cpu().numpy().view(np.uint16)
    nw = nw.cpu().numpy()
    rows = np.zeros((len(nw), max(1, int(nw.max()))), np.uint16)
    for b, n in enumerate(nw):
        rows[b, :n] = w[b, w.shape[1] - n:]
    return (torch.from_numpy(rows.view(np.int16)).to(dev), Rf,
            2 * int(nw.sum()))


def bnd_kernels_vs_plain(np, torch, dev):
    """The boundary-table walks against their plain versions (zero
    tolerance) at B = 64 streams, T = 4096 steps, ragged, with a
    single-symbol stream in every set; tables built from s3 LUTs as the
    engine builds them."""
    from fqzcomp5_tpu_torch.ops import rans_bnd_torch, rans_cuda_bnd
    from fqzcomp5_tpu_torch.ops import rans_torch

    rng = np.random.default_rng(SEED + 2)
    B, T = B_STREAMS, T_STEPS
    cap = T * 32
    res = {}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def streams(make):
        out = []
        for b in range(B):
            n = cap if b == 0 else int(rng.integers(cap // 2, cap + 1))
            d = make(n).astype(np.uint8)
            out.append(np.full(n, d[0], np.uint8) if b == 5 else d)
        return out

    def qual(n, lo, width):
        return np.cumsum(rng.integers(-2, 3, n)) % width + lo

    dna = np.frombuffer(b"ACGTN", np.uint8)
    for want_S, make in (
            (16, lambda n: rng.choice(np.arange(2, 12), n)),
            (48, lambda n: qual(n, 2, 40)),
            (256, lambda n: rng.choice(dna, n, p=[.3, .2, .2, .29, .01]))):
        datas = streams(make)
        freqs, words, R0, coded, lens = _o0_words(datas, dev, np, torch)
        tab, f0, S, packed = rans_bnd_torch.o0_tables(
            rans_torch.build_s3(freqs, 12))
        if S != want_S:
            raise AssertionError(f"decode_bnd_o0: bucket {S}, not {want_S}")
        args = (words, R0, put(tab), put(f0), put(lens // 32), T, S)
        k_ms, k_out = _time(lambda: rans_cuda_bnd.decode_bnd_o0(
            *args, packed=packed), 5)
        p_ms, p_out = _time(lambda: rans_bnd_torch.decode_bnd_o0_ref(
            *args, packed=packed), 1)
        syms = k_out[0].cpu().numpy()
        for b, d in enumerate(datas):
            t = len(d) // 32
            if not np.array_equal(syms[b, :t].reshape(-1), d[:t * 32]):
                raise AssertionError(f"decode_bnd_o0 S={S}: stream {b} does "
                                     "not round-trip")
        _record(res, "decode_bnd_o0",
                f"S={S} {'packed' if packed else 'counter'}",
                _max_err(k_out, p_out), k_ms, p_ms,
                _work("decode_bnd_o0", args, k_out, coded),
                "  (round-trips the sources)")
    # A counts byte 0 too: contexts that never occur have all-zero s3
    # rows, which recover as symbol 0 at f = tot (as in the JAX route)
    for want_A, make in ((6, lambda n: rng.choice(dna, n)),
                         (47, lambda n: qual(n, 36, 46))):
        datas = streams(make)
        for shift in (10, 12):
            freqs, words, R0, coded, iszs = _o1_words(datas, shift, dev, np,
                                                      torch)
            tab, alphabet, A, A1, last0 = \
                rans_bnd_torch.build_o1_dense_tables(
                    rans_bnd_torch.freqs_from_s3(
                        rans_torch.build_s3(freqs, shift).reshape(B, -1),
                        shift), shift)
            if A != want_A:
                raise AssertionError(f"decode_dense_o1: A {A}, not {want_A}")
            args = (words, R0, put(tab), put(iszs), T, shift, A, A1, last0)
            k_ms, k_out = _time(
                lambda: rans_cuda_bnd.decode_dense_o1(*args), 5)
            p_ms, p_out = _time(
                lambda: rans_bnd_torch.decode_dense_o1_ref(*args), 1)
            syms = k_out[0].cpu().numpy()
            for b, d in enumerate(datas):
                isz = int(iszs[b])
                if not np.array_equal(alphabet[syms[b, :isz]].T.reshape(-1),
                                      d[:32 * isz]):
                    raise AssertionError(
                        f"decode_dense_o1 A={A} shift{shift}: stream {b} "
                        "does not round-trip")
            _record(res, "decode_dense_o1", f"A={A} shift{shift}",
                    _max_err(k_out, p_out), k_ms, p_ms,
                    _work("decode_dense_o1", args, k_out, coded),
                    "  (round-trips the sources)")
    return res


def jax_signatures_vs_cpu(np, torch, dev) -> None:
    """The five JAX-signature functions of ops/rans_bnd_dec.py on one
    small input, on the card (the kernels) against the CPU (the plain
    versions), zero tolerance."""
    from fqzcomp5_tpu_torch.ops import rans_bnd_dec, rans_bnd_torch, rans_torch

    rng = np.random.default_rng(SEED + 3)
    B, S = 8, 48
    datas = [(np.cumsum(rng.integers(-2, 3, int(rng.integers(3000, 9000))))
              % 40 + 2).astype(np.uint8) for _ in range(B)]
    freqs, words, R0, _, lens = _o0_words(datas, dev, np, torch)
    treal = (lens // 32).astype(np.int32)
    W = words.shape[1]
    words128 = np.zeros((B, (W + 127) // 128 * 128), np.int32)
    words128[:, :W] = words.cpu().numpy().view(np.uint16)
    words128 = words128.reshape(B, -1, 128)
    R0 = R0.cpu().numpy()
    R0_128 = np.zeros((B, 128), np.int32)
    R0_128[:, :32] = R0
    ex = rans_bnd_torch.expand4
    f0exp = ex(freqs[:, :1].astype(np.int32))[:, 0, :]
    texp = ex(treal.reshape(-1, 1))[:, 0, :]
    counter = rans_bnd_torch.build_dec_tables(freqs, 12, S)
    packed = rans_bnd_torch.build_dec_tables_p(freqs, 12, S)

    def four(tab):
        return (words128, np.ascontiguousarray(ex(tab).transpose(1, 0, 2)),
                f0exp, R0.reshape(-1, 128), texp)

    T = int(treal.max())
    cases = [("decode_walk", (words128, counter, freqs[:, :1].astype(
                np.int32), R0_128, treal), {"S": S}),
             ("decode_walk4", four(counter), {"S": S}),
             ("decode_walk4v3", four(packed), {"S": S}),
             ("decode_walk4v4", four(packed), {"S": S})]
    o1 = [d[:len(d) // 32 * 32] for d in datas[:4]]
    f1, w1, R1, _, iszs = _o1_words(o1, 12, dev, np, torch)
    tab1, _, A, A1, last0 = rans_bnd_torch.build_o1_dense_tables(
        rans_bnd_torch.freqs_from_s3(
            rans_torch.build_s3(f1, 12).reshape(4, -1), 12), 12)
    W1 = w1.shape[1]
    w1_128 = np.zeros((4, (W1 + 127) // 128 * 128), np.int32)
    w1_128[:, :W1] = w1.cpu().numpy().view(np.uint16)
    cases.append(("decode_walk4v3_o1", (
        w1_128.reshape(4, -1, 128),
        np.ascontiguousarray(ex(tab1).transpose(1, 0, 2)),
        R1.cpu().numpy().reshape(1, 128),
        ex(iszs.reshape(-1, 1))[:, 0, :].astype(np.int32)),
        {"shift": 12, "A": A, "A1": A1, "last0": last0}))
    for name, args, kw in cases:
        fn = getattr(rans_bnd_dec, name)
        Tn = int(iszs.max()) if name.endswith("o1") else T
        got = fn(*(torch.from_numpy(a).to(dev) for a in args), Tn, **kw)
        want = fn(*map(torch.from_numpy, args), Tn, **kw)
        err = _max_err([g.cpu() for g in got], want)
        log(f"  {name} (JAX layout): card vs CPU max_abs_err {err}")
        if err:
            raise AssertionError(f"{name}: the card disagrees with the CPU")


# ---------------------------------------------------------------------
# phases 4-5: corpus, the adaptive batch and the CLI runs

def make_corpus(path: str, target_mb: int, np) -> int:
    """FASTQ of 150 bp reads sampled from a random 1 Mbp reference, with
    random-walk qualities (bench.gen_corpus's model at fixed length)."""
    rng = np.random.default_rng(SEED)
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 1 << 20)
    L = 150
    total = i = 0
    with open(path, "wb") as out:
        while total < target_mb * 1_000_000:
            n = 20000
            off = rng.integers(0, len(chrom) - L, n)
            seq = chrom[off[:, None] + np.arange(L)[None, :]]
            steps = rng.integers(-2, 3, (n, L))
            q = (np.clip(np.cumsum(steps, axis=1) % 40 + 3, 0, 45)
                 + 33).astype(np.uint8)
            blob = b"".join(
                b"@SRR123.%d %d length=150\n" % (i + k, i + k)
                + seq[k].tobytes() + b"\n+\n" + q[k].tobytes() + b"\n"
                for k in range(n))
            i += n
            out.write(blob)
            total += len(blob)
    return total


def prefix_copy(src: str, dst: str, nbytes: int) -> None:
    """Whole records of src up to about nbytes."""
    with open(src, "rb") as fp:
        head = fp.read(nbytes)
    lines = head.split(b"\n")
    keep = (len(lines) - 1) // 4 * 4
    with open(dst, "wb") as fp:
        fp.write(b"\n".join(lines[:keep]) + b"\n")


def run_cli(argv) -> None:
    from fqzcomp5_tpu_torch import cli

    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exited {rc}")


def same(a: str, b: str) -> None:
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"{a} and {b} differ")


def e2e(src: str, work: str, lvl: str) -> str:
    """Encode src at preset lvl through the port's CLI (on the card, its
    default), decode it with the port and with the host engine (-e
    host), and require both to equal src.  Returns the archive's path."""
    comp = os.path.join(work, f"c{lvl}.fqz5")
    out = os.path.join(work, f"o{lvl}.fastq")
    run_cli([lvl, "-V", src, comp])
    run_cli(["-d", "-V", comp, out])
    same(src, out)
    os.remove(out)
    subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli",
                    "-e", "host", "-d", "-V", comp, out], cwd=ROOT,
                   check=True)
    same(src, out)
    os.remove(out)
    log(f"e2e {lvl}: {os.path.getsize(src)} -> {os.path.getsize(comp)} "
        "bytes; both decodes match the source")
    return comp


def decode_boundary(src: str, comp: str, work: str) -> None:
    """Decode comp through the port's CLI with FQZ5_DEC_V3=1 (the
    boundary-table walks) and require it to equal src."""
    out = os.path.join(work, "bnd.fastq")
    os.environ["FQZ5_DEC_V3"] = "1"
    try:
        run_cli(["-d", "-V", comp, out])
    finally:
        del os.environ["FQZ5_DEC_V3"]
    same(src, out)
    os.remove(out)


def adaptive_vs_host(src: str, dev) -> None:
    """The first 10 MB block's seq and qual under SEQ10, SEQ12B, FQZ1 and
    FQZ3 as one adaptive batch on the card, against the native host
    codecs."""
    from fqzcomp5_tpu_torch import fastq
    from fqzcomp5_tpu_torch.codecs import host
    from fqzcomp5_tpu_torch.ops import adaptive_batch

    fq = fastq.Parser(fastq.open_input(src)).next_batch(10_000_000)
    jobs = [("seq", fq.seq_buf, fq.lens, 0, 10),
            ("seq", fq.seq_buf, fq.lens, 1, 12),
            ("fqz", fq.qual_buf, fq.lens, fq.flags, fq.seq_buf, 1),
            ("fqz", fq.qual_buf, fq.lens, fq.flags, fq.seq_buf, 3)]
    t1 = time.monotonic()
    got = adaptive_batch.encode_adaptive_batch(jobs, dev)
    dev_s = time.monotonic() - t1
    t1 = time.monotonic()
    want = [host.seq_encode(*j[1:]) if j[0] == "seq"
            else host.fqz_compress(*j[1:]) for j in jobs]
    host_s = time.monotonic() - t1
    for k, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(f"adaptive job {k} ({jobs[k][0]}): card "
                                 "payload differs from the host codec's")
    log(f"adaptive batch of the first block ({len(fq.seq_buf)} seq + "
        f"{len(fq.qual_buf)} qual bytes, 4 jobs): card {dev_s:.3f} s, host "
        f"codecs {host_s:.3f} s; payloads {[len(g) for g in got]} equal")


def corrupt_on_card(work: str) -> None:
    """Corrupt -1 and -3 archives (torch_cases.corrupt_archive, seeds 0-7,
    of a 6.6 MB torch_cases.corrupt_corpus) decoded through the port's
    CLI on the card, through both table forms, each in its own subprocess
    with a timeout, eight at a time: each must exit 0, or 1 with ERROR:
    and no traceback (a kernel's trap, or any other CUDA error, surfaces
    as a traceback)."""
    from concurrent.futures import ThreadPoolExecutor

    src = os.path.join(work, "corrupt.fastq")
    with open(src, "wb") as fp:
        fp.write(torch_cases.corrupt_corpus(20000, 150))
    jobs = []
    for lvl in ("-1", "-3"):
        comp = os.path.join(work, f"corrupt{lvl}.fqz5")
        run_cli([lvl, "-V", src, comp])
        with open(comp, "rb") as fp:
            raw = fp.read()
        for seed in range(CORRUPT_SEEDS):
            bad, what = torch_cases.corrupt_archive(raw, seed)
            path = os.path.join(work, f"bad{lvl}_{seed}.fqz5")
            with open(path, "wb") as fp:
                fp.write(bad)
            jobs += [(lvl, seed, what, route, path)
                     for route in ("lut", "boundary")]

    def run(job):
        _, _, _, route, path = job
        env = {k: v for k, v in os.environ.items() if k != "FQZ5_DEC_V3"}
        if route == "boundary":
            env["FQZ5_DEC_V3"] = "1"
        t1 = time.monotonic()
        try:
            p = subprocess.run(
                [sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "-d", "-V",
                 path, f"{path}.{route}.fastq"], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=CORRUPT_TIMEOUT_S)
            return job, p.returncode, p.stderr, time.monotonic() - t1
        except subprocess.TimeoutExpired:
            return job, None, "timed out", time.monotonic() - t1

    with ThreadPoolExecutor(8) as ex:
        results = list(ex.map(run, jobs))
    failed = []
    for (lvl, seed, what, route, _), rc, err, sec in results:
        last = err.strip().splitlines()[-1][:100] if err.strip() else ""
        log(f"  corrupt {lvl} seed {seed} ({what}), {route} tables: exit "
            f"{rc} in {sec:.1f} s  {last}")
        if not (rc == 0 or rc == 1 and "ERROR:" in err
                and "Traceback" not in err):
            failed.append((lvl, seed, route, rc, err[-2000:]))
    if failed:
        raise AssertionError(f"corrupt archives that did not end in exit 0 "
                             f"or ERROR: and exit 1: {failed}")
    if not any(r[1] == 0 for r in results):
        raise AssertionError("no corrupt archive decoded to its end: the "
                             "mutations did not reach the walks")
    log(f"corrupt archives: {len(results)} decodes, "
        f"{sum(r[1] == 0 for r in results)} exit 0, "
        f"{sum(r[1] == 1 for r in results)} ERROR: and exit 1")


def start_cpu_encodes(src: str, work: str) -> list:
    """For each of PREFIXES, writes the prefix of src and starts its CPU
    encode (plain versions) in a subprocess (--cpu-encode).  Returns
    [(preset, MB, prefix path, archive path, Popen)]."""
    jobs = []
    for lvl, mb in PREFIXES:
        pre = os.path.join(work, f"prefix{lvl}.fastq")
        prefix_copy(src, pre, mb * 1_000_000)
        out = os.path.join(work, f"prefix{lvl}.cpu.fqz5")
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-encode", lvl,
             pre, out], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        jobs.append((lvl, mb, pre, out, p))
    return jobs


def cpu_encode(lvl: str, src: str, dst: str) -> int:
    """--cpu-encode: encodes src at lvl on the CPU (plain versions) to
    dst; prints the seconds it took."""
    import torch

    sys.path.insert(0, ROOT)
    from fqzcomp5_tpu_torch import cli, cuda_driver

    torch.set_num_threads(2)
    arg, _, _ = cli.parse_args([lvl, "-V"])
    t1 = time.monotonic()
    with open(dst, "wb") as fp:
        cuda_driver.encode_file(src, fp, arg, cuda_driver.Timings(),
                                torch.device("cpu"))
    print(f"{time.monotonic() - t1:.3f}")
    return 0


def card_vs_cpu(work: str, lvl: str, mb: int, pre: str, cpu_c: str,
                proc) -> None:
    """Encodes the prefix pre at lvl on the card (CLI), waits for its CPU
    encode (start_cpu_encodes) and requires equal archives."""
    gpu_c = os.path.join(work, "prefix.gpu.fqz5")
    run_cli([lvl, "-V", pre, gpu_c])
    out, err = proc.communicate(timeout=CPU_ENCODE_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"CPU encode of the {mb} MB prefix at {lvl} "
                           f"exited {proc.returncode}: {err[-2000:]}")
    same(gpu_c, cpu_c)
    log(f"{mb} MB prefix at {lvl}: card and CPU (plain versions) archives "
        f"are equal (CPU encode {out.strip()} s, in a subprocess beside "
        f"the card's phases)")
    for p in (pre, gpu_c, cpu_c):
        os.remove(p)


def counted_kernels() -> dict:
    """{name: wrapper} of the nine kernels; each wrapper's .launches
    counts its kernel's launches."""
    from fqzcomp5_tpu_torch.ops import (model_cuda, rans_cuda, rans_cuda_bnd,
                                        rans_cuda_dec, rc_cuda)

    return {"encode_walk": rans_cuda.encode_walk,
            "decode_o0": rans_cuda_dec.decode_o0,
            "decode_o1": rans_cuda_dec.decode_o1,
            "decode_bnd_o0": rans_cuda_bnd.decode_bnd_o0,
            "decode_dense_o1": rans_cuda_bnd.decode_dense_o1,
            "evolve_128": model_cuda.evolve_128,
            "evolve_256": model_cuda.evolve_256,
            "tiny_evolve": model_cuda.tiny_evolve,
            "rc_encode_walk": rc_cuda.encode_walk}


class Counts:
    """The nine kernels' launch counts and the decode batch functions'
    calls, read around each path: reset() just before it, read() just
    after it.  launches totals every path read (and the
    counts of the subprocesses added with take())."""

    def __init__(self):
        from fqzcomp5_tpu_torch import engine_cuda

        self.counted = counted_kernels()
        self.batches = {"decode_o0": engine_cuda.decode_o0_batch,
                        "decode_o1": engine_cuda.decode_o1_batch}
        self.launches = dict.fromkeys(self.counted, 0)

    def reset(self) -> None:
        for fn in self.counted.values():
            fn.launches = 0
        for fn in self.batches.values():
            fn.calls = 0

    def read(self, path: str, need, decoders) -> None:
        """Counts of the path just run.  Every kernel in need must have
        launched in it, and decoders[batch] wherever the decode handed
        that batch function a batch."""
        self.take(path, {name: fn.launches for name, fn in
                         self.counted.items()},
                  {name: fn.calls for name, fn in self.batches.items()},
                  need, decoders)

    def take(self, path: str, got: dict, calls: dict, need, decoders,
             note: str = "") -> None:
        """Checks and totals the counts got (and batch calls) of a path
        run here or in a subprocess."""
        need = [*need, *(k for b, k in decoders.items() if calls.get(b))]
        log(f"kernel launches in the {path} run: {got}; decode batches "
            f"{calls}{note}")
        missing = [k for k in need if got[k] == 0]
        if missing:
            raise AssertionError(f"kernels of the {path} path never "
                                 f"launched in its run: {missing}")
        for k in self.launches:
            self.launches[k] += got[k]


def dist_rank(argv) -> int:
    """--dist-rank ARGS: one rank of the port's distributed entry
    (fqzcomp5_tpu_torch.parallel.distributed.main(ARGS)), then its
    kernels' launch counts as one JSON line."""
    sys.path.insert(0, ROOT)
    from fqzcomp5_tpu_torch.parallel import distributed

    rc = distributed.main(argv)
    print(json.dumps({"rank_launches": int(os.environ["FQZ5_DIST_PID"]),
                      **{k: fn.launches
                         for k, fn in counted_kernels().items()}}),
          flush=True)
    return rc


def dist_run(nprocs: int, args, env=None) -> list:
    """Runs nprocs ranks of --dist-rank ARGS on 127.0.0.1 (gloo), each
    within DIST_TIMEOUT_S; any rank that fails or times out fails the
    run, and every rank is stopped.  Returns [(FQZ5_DIST_STATS line,
    launch counts)] by rank."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for pid in range(nprocs):
        e = {k: v for k, v in os.environ.items()
             if k not in ("FQZ5_DIST_LOCAL_MESH", "FQZ5_DEC_V3")}
        e.update({"FQZ5_DIST_COORD": f"127.0.0.1:{port}",
                  "FQZ5_DIST_NPROCS": str(nprocs),
                  "FQZ5_DIST_PID": str(pid), "FQZ5_DIST_STATS": "1",
                  **(env or {})})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank",
             *map(str, args)], cwd=ROOT, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DIST_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for pid, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(f"rank {pid} of {' '.join(map(str, args))} "
                               f"exited {rc}: {err[-3000:]}")
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        res.append((next(d for d in lines if "dist_stat" in d),
                    next(d for d in lines if "rank_launches" in d)))
    return res


def scale_mesh(torch):
    """Every visible card (dp x 2 when their count is even), or cuda:0
    twice (1 x 2) when one is visible."""
    from fqzcomp5_tpu_torch.parallel.pipeline import make_mesh

    n = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(n)]
    return make_mesh(devs * 2 if n == 1 else devs,
                     sp=2 if n == 1 or n % 2 == 0 else 1)


def scale(src: str, nbytes: int, work: str, comp1: str, mesh, dev0,
          dist_args, counts: Counts) -> None:
    """The scale phase: the wave engine over `mesh` and under
    torch.distributed, each archive against one device's and each decode
    against the source.  comp1: the e2e phase's -1 archive of src; dev0:
    the one device; dist_args: extra arguments of every rank."""
    from fqzcomp5_tpu_torch import cli, cuda_driver, drivers

    one = len(set(mesh.devices)) == 1
    note = (f"; {mesh.size} slots of one card run one after another: not "
            "multi-GPU scaling" if one else f"; {mesh.size} cards")
    log(f"scale: mesh {mesh}")

    def timed(what, size, fn):
        t1 = time.monotonic()
        fn()
        sec = time.monotonic() - t1
        log(f"scale {what}: {sec:.3f} s = {size / sec / 1e6:.2f} MB/s{note}")

    def encode(path, dst, arg, dev):
        with open(dst, "wb") as fp:
            cuda_driver.encode_file(path, fp, arg, cuda_driver.Timings(), dev)

    arg1, _, _ = cli.parse_args(["-1", "-V"])
    comp = os.path.join(work, "mesh-1.fqz5")
    counts.reset()
    timed("-1 encode over the mesh", nbytes,
          lambda: encode(src, comp, arg1, mesh))
    counts.read("scale -1 mesh encode", ["encode_walk"], {})
    same(comp, comp1)
    os.remove(comp)
    argd, _, _ = cli.parse_args(["-d", "-V"])
    out = os.path.join(work, "scale.fastq")
    for tables, need, decoders in (
            ("lut", [], {"decode_o0": "decode_o0", "decode_o1": "decode_o1"}),
            ("boundary", [BOUNDARY["-1"]], {"decode_o0": "decode_bnd_o0"})):
        def decode():
            with open(comp1, "rb") as fp, open(out, "wb") as o:
                cuda_driver.decode_file(fp, drivers.make_fastq_writer(o, argd),
                                        argd, cuda_driver.Timings(), mesh,
                                        tables=tables)
        counts.reset()
        timed(f"-1 decode over the mesh ({tables} tables)", nbytes, decode)
        counts.read(f"scale -1 mesh decode ({tables})", need, decoders)
        same(src, out)
        os.remove(out)

    pre = os.path.join(work, "scale-prefix.fastq")
    prefix_copy(src, pre, int(SCALE_PREFIX_MB * 1_000_000))
    pbytes = os.path.getsize(pre)
    arg5, _, _ = cli.parse_args(["-5", "-V"])
    arg5.blk_size = SCALE_BLK
    c5m, c5 = (os.path.join(work, f"scale-5{k}.fqz5") for k in ("m", "1"))
    for dev, dst, what in ((mesh, c5m, "over the mesh"),
                           (dev0, c5, f"on {dev0} alone")):
        counts.reset()
        timed(f"-5 -b {SCALE_BLK} encode of the {pbytes}-byte prefix {what}",
              pbytes, lambda: encode(pre, dst, arg5, dev))
        counts.read(f"scale -5 prefix {what}", dict(PATHS)["-5"], {})
    same(c5m, c5)
    os.remove(c5m)

    def ranks(what, nprocs, size, args, env=None):
        t1 = time.monotonic()
        res = dist_run(nprocs, [*args, *dist_args], env)
        sec = time.monotonic() - t1
        log(f"scale distributed {what}: {sec:.3f} s = "
            f"{size / sec / 1e6:.2f} MB/s, {nprocs} ranks{note}")
        for st, ln in res:
            log(f"  rank {st['dist_stat']}: {json.dumps(st)}; kernel "
                f"launches {json.dumps(ln)}")
            for k in counts.launches:
                counts.launches[k] += ln[k]
        return res

    dcomp = os.path.join(work, "dist-1.fqz5")
    res = ranks("-1 encode", 2, nbytes, ["-1", "-e", "cuda", src, dcomp])
    same(dcomp, comp1)
    if any(ln["encode_walk"] == 0 for _, ln in res):
        raise AssertionError("a rank of the distributed -1 encode never "
                             "launched encode_walk")
    parsed = sum(st["parse_bytes"] for st, _ in res)
    if parsed > nbytes + 1024:
        raise AssertionError(f"the ranks parsed {parsed} bytes of a "
                             f"{nbytes}-byte input")
    dcomp5 = os.path.join(work, "dist-5.fqz5")
    res = ranks("-5 encode of the prefix, a 1x2 local mesh a rank", 2, pbytes,
                ["-5", "-b", SCALE_BLK, "-e", "cuda", pre, dcomp5],
                {"FQZ5_DIST_LOCAL_MESH": "1x2"})
    same(dcomp5, c5)
    # rank 0 owns the wave of trial blocks, which tries every method; the
    # later wave runs only the methods the learner locked
    missing = [k for k in dict(PATHS)["-5"] if res[0][1][k] == 0]
    if missing:
        raise AssertionError(f"rank 0 of the distributed -5 encode (the "
                             f"trial wave) never launched {missing}")
    if not any(res[1][1][k] for k in dict(PATHS)["-5"]):
        raise AssertionError("rank 1 of the distributed -5 encode launched "
                             "no kernel of the path")
    ranks("-1 decode (host)", 2, nbytes, ["-d", dcomp, out])
    same(src, out)
    for p in (out, dcomp, dcomp5, c5, pre):
        os.remove(p)


def timed_cli(argv) -> int:
    """--timed-cli ARGS: runs the port's CLI on ARGS and prints its wall
    seconds as the last line (the native encodes of the host-adaptive
    phase, in subprocesses beside the card's phases)."""
    sys.path.insert(0, ROOT)
    from fqzcomp5_tpu_torch import cli

    t1 = time.monotonic()
    rc = cli.main(argv)
    print(f"{time.monotonic() - t1:.3f}", flush=True)
    return rc


def start_host_encodes(src: str, work: str) -> list:
    """For each of HOST_ADAPTIVE_RUNS, writes its prefix of src and
    starts the native -e host encode of it (no FQZ5_DEVICE_ADAPTIVE) in a
    subprocess (--timed-cli): the host-adaptive phase's references.
    Returns [(run, prefix, argv, archive, Popen)]."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FQZ5_DEVICE_ADAPTIVE")}
    jobs = []
    for k, (what, mb, extra) in enumerate(HOST_ADAPTIVE_RUNS):
        pre = os.path.join(work, f"host-adaptive{k}.fastq")
        prefix_copy(src, pre, mb * 1_000_000)
        argv = ["-e", "host", "-5", *extra, "-V", pre]
        out = os.path.join(work, f"host-adaptive{k}.native.fqz5")
        jobs.append((what, pre, argv, out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--timed-cli", *argv,
             out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return jobs


def host_adaptive(work: str, jobs, counts: Counts) -> None:
    """The host-adaptive phase: the CLI's -e host -5 with
    FQZ5_DEVICE_ADAPTIVE=1 (each block's SEQ/FQZ trials sent to the card
    as one-job batches, from the driver's 4 threads) on each of
    HOST_ADAPTIVE_RUNS' prefixes.  Each archive must equal its native -e
    host encode (start_host_encodes), the four adaptive kernels must have
    launched and the rANS encode walk not; the first archive is decoded
    with -e host and must equal its prefix."""
    import torch

    for k, (what, pre, argv, native_c, proc) in enumerate(jobs):
        nbytes = os.path.getsize(pre)
        comp = os.path.join(work, "host-adaptive.fqz5")
        counts.reset()
        torch.cuda.reset_peak_memory_stats()
        os.environ["FQZ5_DEVICE_ADAPTIVE"] = "1"
        try:
            t1 = time.monotonic()
            run_cli([*argv, comp])
            sec = time.monotonic() - t1
        finally:
            del os.environ["FQZ5_DEVICE_ADAPTIVE"]
        peak = torch.cuda.max_memory_allocated()
        counts.read(f"host-adaptive {what}", ADAPTIVE_KERNELS, {})
        if counts.counted["encode_walk"].launches:
            raise AssertionError(f"host-adaptive {what}: the per-block route "
                                 "launched the rANS encode walk")
        out, err = proc.communicate(timeout=CPU_ENCODE_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"native -e host encode of {what} exited "
                               f"{proc.returncode}: {err[-2000:]}")
        same(comp, native_c)
        log(f"host-adaptive {what}: {nbytes} -> {os.path.getsize(comp)} "
            f"bytes; route {sec:.3f} s = {nbytes / sec / 1e6:.2f} MB/s, peak "
            f"device memory {peak} bytes; native -e host "
            f"{out.split()[-1]} s (a subprocess beside the card's phases); "
            "archives equal")
        if k == 0:
            dec = os.path.join(work, "host-adaptive.out.fastq")
            t1 = time.monotonic()
            run_cli(["-e", "host", "-d", "-V", comp, dec])
            same(pre, dec)
            log(f"host-adaptive {what}: -e host decode "
                f"{time.monotonic() - t1:.3f} s, equal to the prefix")
            os.remove(dec)
        for p in (comp, native_c, pre):
            os.remove(p)


def daemon_serve(sock: str, work: str) -> int:
    """--daemon-serve SOCK DIR: the port's daemon on SOCK.  Before it
    serves, prints one JSON line (whether _preload loaded the kernel
    library and left CUDA uninitialised), and wraps the CLI's main so
    that each forked child writes DIR/child-PID.json: its argv, seconds,
    the first CUDA call's seconds (a 1-element allocation and a
    synchronize, unless -e host), its kernels' launch counts and its
    decode batches' calls.  The child leaves through os._exit, so the
    record is written in the wrapper and not at exit."""
    sys.path.insert(0, ROOT)
    import torch

    from fqzcomp5_tpu_torch import cli, daemon, engine_cuda
    from fqzcomp5_tpu_torch.ops import _build

    daemon._preload()
    print(json.dumps({"daemon_server": os.getpid(),
                      "kernel_library_loaded": _build._lib is not None,
                      "cuda_initialized": torch.cuda.is_initialized()}),
          flush=True)
    real = cli.main

    def main(argv):
        t0 = time.monotonic()
        first = None
        if "host" not in argv:
            torch.empty(1, device="cuda")
            torch.cuda.synchronize()
            first = time.monotonic() - t0
        try:
            return real(argv)
        finally:
            rec = {"argv": list(argv), "first_cuda_s": first,
                   "seconds": time.monotonic() - t0,
                   "launches": {k: fn.launches
                                for k, fn in counted_kernels().items()},
                   "calls": {"decode_o0": engine_cuda.decode_o0_batch.calls,
                             "decode_o1": engine_cuda.decode_o1_batch.calls}}
            path = os.path.join(work, f"child-{os.getpid()}.json")
            with open(path + ".tmp", "w") as fp:
                json.dump(rec, fp)
            os.replace(path + ".tmp", path)

    cli.main = main
    return daemon.serve(sock, quiet=True)


def gpu_apps() -> list:
    """[(pid, used memory)] of the processes holding a CUDA context, as
    nvidia-smi --query-compute-apps lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return [tuple(x.strip() for x in line.split(",", 1))
            for line in out.splitlines() if line.strip()]


def _has_nvidia_fd(pid: int) -> bool:
    """Whether process pid has a /dev/nvidia* device open (a CUDA
    context)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def cancel_on_card(sock: str, server_pid: int, src: str, work: str,
                   env: dict) -> None:
    """A -5 encode of src through the C client, killed (SIGKILL) once its
    job child holds a CUDA context: within CANCEL_GONE_S the child must
    be gone from /proc and from nvidia-smi's compute apps, and its output
    must stop growing.  nvidia-smi may list pids of another namespace (in
    some containers every entry reads pid 1); then the child's context
    is the entry that appeared beside a /dev/nvidia* fd of the child,
    and the list must shrink back to its length before the job."""
    before = gpu_apps()
    out = os.path.join(work, "cancel-5.fqz5")
    err_path = os.path.join(work, "cancel.err")
    with open(err_path, "wb") as err:
        cp = subprocess.Popen([CLIENT, "-5", "-V", src, out], cwd=ROOT,
                              env=env, stdin=subprocess.DEVNULL,
                              stdout=subprocess.DEVNULL, stderr=err)
    try:
        t1 = time.monotonic()
        kid = None
        while True:
            if cp.poll() is not None:
                with open(err_path) as fp:
                    raise RuntimeError(f"the -5 client exited {cp.returncode}"
                                       f" before it was killed: "
                                       f"{fp.read()[-2000:]}")
            if time.monotonic() - t1 > CANCEL_START_S:
                raise RuntimeError(f"no CUDA context of the -5 job in "
                                   f"{CANCEL_START_S} s (nvidia-smi "
                                   f"{gpu_apps()}, job {kid})")
            kids = torch_cases.job_children(server_pid)
            if kids:
                kid, = kids
                apps = gpu_apps()
                if any(pid == str(kid) for pid, _ in apps) or (
                        len(apps) > len(before) and _has_nvidia_fd(kid)):
                    break
            time.sleep(0.2)
        held = time.monotonic() - t1
        cp.kill()
        cp.wait(timeout=60)
        t2 = time.monotonic()
        while True:
            after = gpu_apps()
            if (not os.path.exists(f"/proc/{kid}")
                    and not any(pid == str(kid) for pid, _ in after)
                    and len(after) <= len(before)):
                break
            if time.monotonic() - t2 > CANCEL_GONE_S:
                alive = os.path.exists(f"/proc/{kid}")
                raise AssertionError(
                    f"the -5 job {kid} outlived its killed client by "
                    f"{CANCEL_GONE_S} s: in /proc {alive}, nvidia-smi "
                    f"{after} (before the job {before})")
            time.sleep(0.1)
        gone_s = time.monotonic() - t2
        size = os.path.getsize(out) if os.path.exists(out) else 0
        time.sleep(1.0)
        if (os.path.getsize(out) if os.path.exists(out) else 0) != size:
            raise AssertionError("the cancelled job's output still grows")
        log(f"daemon cancel: the -5 job {kid} held a CUDA context after "
            f"{held:.3f} s (nvidia-smi {apps}, before the job {before}); its "
            f"client was killed, and the job and its context were gone "
            f"{gone_s:.3f} s later (nvidia-smi {after}); output {size} "
            f"bytes, not growing")
    finally:
        if cp.poll() is None:
            cp.kill()
            cp.wait()
    _child_records(work)   # none is expected from the killed job
    if os.path.exists(out):
        os.remove(out)


def seq_qual_bytes(path: str) -> int:
    """Bytes of the sequence and quality lines of a FASTQ file."""
    with open(path, "rb") as fp:
        lines = fp.read().split(b"\n")
    return sum(len(x) for x in lines[1::4]) + sum(len(x) for x in lines[3::4])


def _child_records(work: str) -> list:
    """The daemon children's records (daemon_serve) written so far; each
    is removed once read."""
    recs = []
    for name in sorted(os.listdir(work)):
        if name.startswith("child-") and name.endswith(".json"):
            with open(os.path.join(work, name)) as fp:
                recs.append(json.load(fp))
            os.remove(os.path.join(work, name))
    return recs


def daemon_phase(src: str, nbytes: int, work: str, comp1: str,
                 counts: Counts) -> None:
    """The daemon phase: the port's daemon (--daemon-serve, a subprocess)
    on the card.  The corpus at -1 through it (equal to the e2e archive
    comp1), its -d (equal to the source) and again with FQZ5_DEC_V3=1
    forwarded; the corpus at -1 and its -d again through the C client
    (bin/fqz5-torch, built here at first use); two concurrent requests (a
    -1 encode of a 4 MB prefix and the decode of that prefix's archive),
    each equal to its direct run; five -1 encodes of the prefix each
    through the C client, daemon.request and as fresh processes, and five
    requests that fail at once through the C client and the Python
    launcher, each wall time logged with the children's first CUDA
    call.  Then a -5 encode of the corpus through the C client, killed
    once its job holds a CUDA context (cancel_on_card), after which the
    server must answer ping and a -1 encode of the prefix through the C
    client must equal its direct run.  Every child's launch counts must
    show its path's kernels."""
    import threading

    sys.path.insert(0, ROOT)
    from fqzcomp5_tpu_torch import daemon

    sock = os.path.join(work, "d.sock")
    err_path = os.path.join(work, "daemon.err")
    with open(err_path, "w") as err:
        server = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--daemon-serve",
             sock, work], cwd=ROOT, stdout=subprocess.PIPE, stderr=err,
            text=True)
    dec_paths = {"decode_o0": "decode_o0", "decode_o1": "decode_o1"}

    def check(what, rec, need, decoders):
        counts.take(f"daemon {what} (child)", rec["launches"], rec["calls"],
                    need, decoders,
                    f"; first CUDA call {rec['first_cuda_s']} s, "
                    f"child {rec['seconds']} s")

    cenv = {k: v for k, v in os.environ.items() if k != "FQZ5_NO_DAEMON"}
    cenv["FQZ5_DAEMON"] = sock

    def send(argv, via):
        """(exit code, stderr) of argv through daemon.request, the C
        client or the Python launcher (a fresh interpreter)."""
        if via == "request":
            return daemon.request(sock, argv), ""
        entry = ([CLIENT] if via == "client" else
                 [sys.executable, "-m", "fqzcomp5_tpu_torch.launcher"])
        r = subprocess.run([*entry, *argv], cwd=ROOT, env=cenv,
                           stderr=subprocess.PIPE, text=True,
                           timeout=CPU_ENCODE_TIMEOUT_S)
        if via == "client" and ("warning" in r.stderr or not os.access(
                os.path.join(ROOT, CLIENT_EXE), os.X_OK)):
            raise RuntimeError(f"the C client was not built: "
                               f"{r.stderr[-2000:]}")
        return r.returncode, r.stderr

    def job(what, argv, need, decoders, size, via="request"):
        """One request through send(); its wall seconds."""
        t1 = time.monotonic()
        rc, _ = send(argv, via)
        sec = time.monotonic() - t1
        what = f"{what}{'' if via == 'request' else f' ({via})'}"
        if rc != 0:
            raise RuntimeError(f"daemon {what}: {argv} exited {rc}")
        rec, = _child_records(work)
        check(what, rec, need, decoders)
        log(f"daemon {what}: {sec:.3f} s = {size / sec / 1e6:.2f} MB/s")
        return sec

    try:
        t1 = time.monotonic()
        while not daemon.request(sock, None, op="ping"):
            if server.poll() is not None or time.monotonic() - t1 > 600:
                with open(err_path) as fp:
                    raise RuntimeError(f"the daemon never answered: "
                                       f"{fp.read()[-3000:]}")
            time.sleep(0.2)
        ready = json.loads(server.stdout.readline())
        log(f"daemon: serving after {time.monotonic() - t1:.3f} s; {ready}")
        if not ready["kernel_library_loaded"] or ready["cuda_initialized"]:
            raise AssertionError("the daemon server must load the kernel "
                                 "library and leave CUDA uninitialised")
        comp = os.path.join(work, "daemon-1.fqz5")
        out = os.path.join(work, "daemon.fastq")
        secs = {}
        for client in (False, True):
            secs[client] = (
                job("-1 encode of the corpus", ["-1", "-V", src, comp],
                    ["encode_walk"], {}, nbytes,
                    "client" if client else "request"),
                job("-1 decode of the corpus", ["-d", "-V", comp, out],
                    ["decode_o0", "decode_o1"] if client else [], dec_paths,
                    nbytes, "client" if client else "request"))
            same(comp, comp1)
            same(src, out)
        log("daemon: the corpus at -1, encode and decode, through the C "
            "client " + ", ".join(f"{s:.3f} s = {nbytes / s / 1e6:.2f} MB/s"
                                 for s in secs[True])
            + "; through daemon.request "
            + ", ".join(f"{s:.3f} s = {nbytes / s / 1e6:.2f} MB/s"
                        for s in secs[False]))
        os.environ["FQZ5_DEC_V3"] = "1"
        try:
            job("-1 decode of the corpus, FQZ5_DEC_V3=1 forwarded",
                ["-d", "-V", comp, out], [BOUNDARY["-1"]],
                {"decode_o0": "decode_bnd_o0"}, nbytes)
        finally:
            del os.environ["FQZ5_DEC_V3"]
        same(src, out)
        for p in (comp, out):
            os.remove(p)

        pre = os.path.join(work, "daemon-prefix.fastq")
        prefix_copy(src, pre, DAEMON_PREFIX_MB * 1_000_000)
        direct = os.path.join(work, "daemon-direct.fqz5")
        run_cli(["-1", "-V", pre, direct])
        enc, dec = (os.path.join(work, f"daemon-{k}") for k in ("c", "o"))
        rcs = {}
        runs = {"encode": ["-1", "-V", pre, enc],
                "decode": ["-d", "-V", direct, dec]}
        threads = [threading.Thread(
            target=lambda k=k: rcs.__setitem__(k, daemon.request(sock,
                                                                 runs[k])))
            for k in runs]
        t1 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sec = time.monotonic() - t1
        if rcs != {"encode": 0, "decode": 0}:
            raise RuntimeError(f"daemon concurrent requests exited {rcs}")
        same(enc, direct)
        same(dec, pre)
        recs = _child_records(work)
        for k, need, decoders in (("encode", ["encode_walk"], {}),
                                  ("decode", [], dec_paths)):
            rec, = [r for r in recs if r["argv"] == runs[k]]
            check(f"concurrent {k}", rec, need, decoders)
        log(f"daemon: a -1 encode and a decode of the {DAEMON_PREFIX_MB} MB "
            f"prefix at once, {sec:.3f} s, each equal to its direct run")

        walls = {"client": [], "request": [], "fresh": []}
        for via in ("client", "request"):
            for _ in range(STARTUP_RUNS):
                walls[via].append(job(
                    f"-1 encode of the {DAEMON_PREFIX_MB} MB prefix",
                    ["-1", "-V", pre, enc], ["encode_walk"], {},
                    os.path.getsize(pre), via))
                same(enc, direct)
        for _ in range(STARTUP_RUNS):
            t1 = time.monotonic()
            subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli",
                            "-1", "-V", pre, enc], cwd=ROOT, check=True,
                           timeout=CPU_ENCODE_TIMEOUT_S)
            walls["fresh"].append(time.monotonic() - t1)
            same(enc, direct)
        log(f"daemon start-up: -1 encodes of the {DAEMON_PREFIX_MB} MB prefix "
            f"through the C client {walls['client']} s; through "
            f"daemon.request (in this process) {walls['request']} s; as "
            f"fresh processes {walls['fresh']} s")
        # a job that fails at once, on the host: the client's own cost
        # and the round trip, without a CUDA context
        fails = {"client": [], "launcher": []}
        for via in fails:
            for _ in range(STARTUP_RUNS):
                t1 = time.monotonic()
                rc, err = send(["-e", "host", "-1", os.path.join(
                    work, "absent.fastq"), enc + ".x"], via)
                fails[via].append(time.monotonic() - t1)
                if rc != 1 or not err.startswith("ERROR:"):
                    raise RuntimeError(f"a failing request through the "
                                       f"{via}: rc {rc}, {err[-500:]}")
        _child_records(work)
        log(f"daemon round trips: a request that fails at once (-e host, "
            f"no input) through the C client {fails['client']} s; through "
            f"the Python launcher {fails['launcher']} s")

        cancel_on_card(sock, server.pid, src, work, cenv)
        if not daemon.request(sock, None, op="ping"):
            raise RuntimeError("the daemon stopped answering after a "
                               "cancelled job")
        job(f"-1 encode of the {DAEMON_PREFIX_MB} MB prefix after the "
            f"cancelled job", ["-1", "-V", pre, enc], ["encode_walk"], {},
            os.path.getsize(pre), "client")
        same(enc, direct)
        for p in (pre, direct, enc, dec):
            os.remove(p)
    except Exception:
        with open(err_path, errors="replace") as fp:
            log(f"the daemon's stderr: {fp.read()[-3000:]}")
        raise
    finally:
        daemon.stop(sock)
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()


def devtime_phase(src: str, nbytes: int, work: str, comp1: str,
                  counts: Counts) -> None:
    """The devtime phase: FQZ5_DEVTIME's accounting (ops/devtimer.py) on
    the card, in-process.  The corpus at -1 (encode, cmp with the e2e
    archive comp1; decode, cmp with the source) and the 1 MB prefix at -5
    (cmp with its encode without the switch), each with the counts set
    to 0 before it and read after it.  Logs link_s, link_bytes, compute_s,
    compute_calls and the wall seconds of each run; compute_calls must be
    > 0, and on the corpus link_bytes must be at least its seq+qual
    bytes."""
    from fqzcomp5_tpu_torch.ops import devtimer

    pre = os.path.join(work, "devtime-prefix.fastq")
    prefix_copy(src, pre, 1_000_000)
    ref5 = os.path.join(work, "devtime-ref-5.fqz5")
    t1 = time.monotonic()
    run_cli(["-5", "-V", pre, ref5])
    off5 = time.monotonic() - t1
    sq = seq_qual_bytes(src)
    comp = os.path.join(work, "devtime-1.fqz5")
    out = os.path.join(work, "devtime.fastq")
    comp5 = os.path.join(work, "devtime-5.fqz5")
    runs = (("-1 encode of the corpus", ["-1", "-V", src, comp], comp, comp1,
             ["encode_walk"], {}, sq),
            ("-1 decode of the corpus", ["-d", "-V", comp, out], out, src,
             [], {"decode_o0": "decode_o0", "decode_o1": "decode_o1"}, sq),
            ("-5 encode of the 1 MB prefix", ["-5", "-V", pre, comp5], comp5,
             ref5, ["encode_walk", *ADAPTIVE_KERNELS], {}, 0))
    try:
        for what, argv, got, want, need, decoders, min_bytes in runs:
            counts.reset()
            devtimer.enabled = True
            devtimer.reset()
            t1 = time.monotonic()
            try:
                run_cli(argv)
                wall = time.monotonic() - t1
                snap = devtimer.snapshot()
            finally:
                devtimer.enabled = False
            counts.read(f"devtime {what}", need, decoders)
            same(got, want)
            log(f"devtime {what}: wall {wall} s; {json.dumps(snap)}"
                + (f" (without FQZ5_DEVTIME: {off5} s)"
                   if got == comp5 else ""))
            if snap["compute_calls"] <= 0 or snap["link_bytes"] < max(
                    min_bytes, 1):
                raise AssertionError(
                    f"devtime {what}: {snap}; link_bytes must be at least "
                    f"{max(min_bytes, 1)} and compute_calls above 0")
        log(f"devtime: each archive equals its run without FQZ5_DEVTIME; "
            f"the corpus's seq+qual bytes {sq}")
    finally:
        devtimer.reset()
        for p in (pre, ref5, comp, out, comp5):
            if os.path.exists(p):
                os.remove(p)


ONLY_PHASES = ("host-adaptive", "daemon", "devtime", "scale")


def only_main(np, torch, names) -> int:
    """--only PHASE[,PHASE...] (--scale: --only scale): only those of
    ONLY_PHASES, in that order, with each run's kernels required.  Builds,
    makes the corpus and encodes it at -1 through the CLI (the daemon's and
    the scale phase's reference archive).  The scale phase runs on a mesh
    of every visible card."""
    from fqzcomp5_tpu_torch import engine_cuda
    from fqzcomp5_tpu_torch.ops import _build

    engine_cuda._lib()
    _build.lib()
    counts = Counts()
    work = tempfile.mkdtemp(prefix="fqz5_chip_only_")
    host_jobs = []
    try:
        src = os.path.join(work, "in.fastq")
        nbytes = make_corpus(src, CORPUS_MB, np)
        if "host-adaptive" in names:
            host_jobs = start_host_encodes(src, work)
        comp1 = os.path.join(work, "c-1.fqz5")
        t1 = time.monotonic()
        run_cli(["-1", "-V", src, comp1])
        log(f"-1 encode of the corpus through the CLI on cuda:0: "
            f"{time.monotonic() - t1:.3f} s")
        for name in ONLY_PHASES:
            if name not in names:
                continue
            t0 = time.monotonic()
            if name == "host-adaptive":
                host_adaptive(work, host_jobs, counts)
            elif name == "daemon":
                daemon_phase(src, nbytes, work, comp1, counts)
            elif name == "devtime":
                devtime_phase(src, nbytes, work, comp1, counts)
            else:
                scale(src, nbytes, work, comp1, scale_mesh(torch),
                      torch.device("cuda", 0), [], counts)
            phase(name, t0)
    finally:
        for *_, p in host_jobs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
    log(f"kernel launches of {','.join(names)}: {json.dumps(counts.launches)}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walk-times", action="store_true",
                    help="only time the redesigned walks at the main "
                    "path's shapes")
    ap.add_argument("--decode", action="store_true",
                    help="with --walk-times: time only the decode walks")
    ap.add_argument("--root", default=ROOT,
                    help="with --walk-times: the checkout whose "
                    "fqzcomp5_tpu_torch is timed")
    ap.add_argument("--scale", action="store_true",
                    help="only run the scale phase, on every visible card "
                    "(--only scale)")
    ap.add_argument("--only", metavar="PHASE[,PHASE]",
                    help=f"only run these of {', '.join(ONLY_PHASES)}")
    ap.add_argument("--timed-cli", nargs=argparse.REMAINDER,
                    help="only run the port's CLI with these arguments and "
                    "print its seconds (the host-adaptive phase's native "
                    "encodes)")
    ap.add_argument("--daemon-serve", nargs=2, metavar=("SOCK", "DIR"),
                    help="only serve the port's daemon on SOCK, each child "
                    "recording its launch counts under DIR (the daemon "
                    "phase's server)")
    ap.add_argument("--dist-rank", nargs=argparse.REMAINDER,
                    help="only run one rank of the port's distributed entry "
                    "with these arguments (the scale phase's ranks)")
    ap.add_argument("--cpu-encode", nargs=3, metavar=("LEVEL", "IN", "OUT"),
                    help="only encode IN at LEVEL on the CPU (plain "
                    "versions) to OUT; the e2e phase runs this beside the "
                    "card's phases")
    opts = ap.parse_args()
    if opts.dist_rank is not None:
        return dist_rank(opts.dist_rank)
    if opts.cpu_encode:
        return cpu_encode(*opts.cpu_encode)
    if opts.timed_cli is not None:
        return timed_cli(opts.timed_cli)
    if opts.daemon_serve:
        return daemon_serve(*opts.daemon_serve)

    t0 = time.monotonic()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("ERROR: no CUDA device is visible")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda})")
    log(smi)
    phase("device", t0)

    if opts.scale or opts.only:
        names = ["scale"] if opts.scale else opts.only.split(",")
        unknown = set(names) - set(ONLY_PHASES)
        if unknown:
            log(f"ERROR: --only {opts.only}: no phase {sorted(unknown)}")
            return 1
        sys.path.insert(0, ROOT)
        return only_main(np, torch, names)
    if opts.walk_times:
        sys.path.insert(0, os.path.abspath(opts.root))
        from fqzcomp5_tpu_torch.ops import _build
        _build.lib()
        log(f"walk times of {os.path.dirname(_build.CSRC)} (nvcc "
            f"{_build.build_seconds:.3f} s)")
        walk_times(np, torch, torch.device("cuda"), opts.decode)
        return 0
    sys.path.insert(0, ROOT)

    t0 = time.monotonic()
    from fqzcomp5_tpu_torch import engine_cuda
    from fqzcomp5_tpu_torch.ops import _build

    t1 = time.monotonic()
    engine_cuda._lib()  # builds the native host library (make) if absent
    log(f"native host library: {time.monotonic() - t1:.3f} s")
    _build.lib()
    log(f"CUDA kernels: nvcc {_build.build_seconds:.3f} s -> "
        f"{os.path.relpath(_build.lib_path(), ROOT)}")
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as fp:
        for line in fp:
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log("  ptxas: " + line.strip())
    phase("build", t0)

    work = tempfile.mkdtemp(prefix="fqz5_chip_smoke_")
    cpu_jobs = host_jobs = []
    try:
        t0 = time.monotonic()
        src = os.path.join(work, "in.fastq")
        nbytes = make_corpus(src, CORPUS_MB, np)
        log(f"corpus: {nbytes} bytes, 150 bp reads ("
            f"{time.monotonic() - t0:.3f} s)")
        # the CPU halves of the card-vs-CPU prefix encodes run in
        # subprocesses beside the kernels, adaptive and e2e phases
        cpu_jobs = start_cpu_encodes(src, work)
        host_jobs = start_host_encodes(src, work)

        t0 = time.monotonic()
        dev = torch.device("cuda")
        kres = kernels_vs_plain(np, torch, dev)
        kres.update(bnd_kernels_vs_plain(np, torch, dev))
        jax_signatures_vs_cpu(np, torch, dev)
        decode_o1_edge_cases(np, torch, dev)
        dense_o0_edge_cases(np, torch, dev)
        bnd_o0_edge_cases(np, torch, dev)
        kres.update(adaptive_kernels_vs_plain(np, torch, dev))
        # the decode walks' round trips at the main path's launch shapes
        walk_times(np, torch, dev, decode_only=True)
        phase("kernels", t0)

        counts = Counts()
        launches = counts.launches

        t0 = time.monotonic()
        adaptive_vs_host(src, dev)
        phase("adaptive", t0)

        t0 = time.monotonic()
        src5 = os.path.join(work, "e2e-5.fastq")
        prefix_copy(src, src5, E2E_ADAPTIVE_MB * 1_000_000)
        for lvl, runs in PATHS:
            counts.reset()
            torch.cuda.reset_peak_memory_stats()
            comp = e2e(src5 if lvl == "-5" else src, work, lvl)
            log(f"peak device memory in the {lvl} run: "
                f"{torch.cuda.max_memory_allocated()} bytes")
            counts.read(lvl, runs, {"decode_o0": "decode_o0",
                                    "decode_o1": "decode_o1"})
            if lvl in BOUNDARY:
                counts.reset()
                decode_boundary(src, comp, work)
                counts.read(f"{lvl} FQZ5_DEC_V3 decode", [BOUNDARY[lvl]],
                            {"decode_o0": "decode_bnd_o0"})
            if lvl == "-1":
                comp1 = comp   # the daemon's and scale phase's reference
            else:
                os.remove(comp)
        os.remove(src5)
        zero = [k for k, v in launches.items() if v == 0]
        if zero:
            raise AssertionError(f"kernels never launched on the main paths: "
                                 f"{zero}")
        for job in cpu_jobs:
            card_vs_cpu(work, *job)
        phase("e2e", t0)
        t0 = time.monotonic()
        torch.cuda.empty_cache()
        host_adaptive(work, host_jobs, counts)
        phase("host-adaptive", t0)
        t0 = time.monotonic()
        daemon_phase(src, nbytes, work, comp1, counts)
        phase("daemon", t0)
        t0 = time.monotonic()
        devtime_phase(src, nbytes, work, comp1, counts)
        phase("devtime", t0)
        t0 = time.monotonic()
        torch.cuda.empty_cache()
        scale(src, nbytes, work, comp1, scale_mesh(torch),
              torch.device("cuda", 0), [], counts)
        os.remove(comp1)
        phase("scale", t0)
        t0 = time.monotonic()
        corrupt_on_card(work)
        phase("corrupt", t0)
    finally:
        for *_, p in cpu_jobs + host_jobs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)

    dec = "fqzcomp5_tpu/ops/rans_pallas_dec.py"
    src_of = {"encode_walk": "csrc/rans_encode.cu",
              "decode_o0": "csrc/rans_decode.cu",
              "decode_o1": "csrc/rans_decode.cu",
              "decode_bnd_o0": "csrc/rans_decode_bnd.cu",
              "decode_dense_o1": "csrc/rans_decode_bnd.cu",
              "evolve_128": "csrc/fqz_evolve.cu",
              "evolve_256": "csrc/fqz_evolve.cu",
              "tiny_evolve": "csrc/fqz_evolve.cu",
              "rc_encode_walk": "csrc/rc_encode.cu"}
    replaces = {"encode_walk": "fqzcomp5_tpu/ops/rans_pallas.py:140",
                "decode_o0": f"{dec}:1226",
                "decode_o1": f"{dec}:1396",
                "decode_bnd_o0": f"{dec}:665; :234; :406; :1590",
                "decode_dense_o1": f"{dec}:908",
                "evolve_128": "fqzcomp5_tpu/ops/model_pallas.py:131",
                "evolve_256": "fqzcomp5_tpu/ops/fqz_model_jax.py:38",
                "tiny_evolve": "fqzcomp5_tpu/ops/fqz_model_jax.py:107",
                "rc_encode_walk": "fqzcomp5_tpu/ops/rc_pallas.py:164"}
    kernels = []
    for name, rows in kres.items():
        n = len(rows)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fqzcomp5_tpu_torch/" + src_of[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r[1] for r in rows + [
                (None, e) for e in EDGE_ERRS.get(name, [])]),
            "ms": sum(r[2] for r in rows) / n,
            "plain_ms": sum(r[3] for r in rows) / n,
            "bound_ms": sum(r[4] for r in rows) / n,
            "bound_by": max(rows, key=lambda r: r[4])[5],
            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
