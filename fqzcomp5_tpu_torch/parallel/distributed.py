"""Multi-process encode and decode over torch.distributed.

The counterpart of the JAX package's ``parallel/distributed.py``.  The
reference's parallelism is one thread pool feeding serial-ordered
results to a single writer (thread_pool.c:113-164 ->
fqzcomp5.c:3063-3120), with one reader parsing blocks for the workers.
Across processes:

- every process joins one ``torch.distributed`` group over gloo
  (``init``).  The exchanges carry host bytes only (payloads, trial
  journals, FASTQ text) that rank 0 writes to a file, so gloo moves
  them; NCCL would add two copies over the link, and it refuses two
  ranks on one card, which is how a one-card host runs several;
- a byte-range pre-scan (fastq.scan_blocks) finds every block's extent
  once, so each process parses only the blocks it owns;
- blocks go round-robin by serial: process p owns the serials s with
  s % num_processes == p;
- the method learner evolves identically on every process.  A trial
  block is encoded by its owner only, and the owner's trial stats reach
  the peers as a small JSON journal (learning.journal_dumps) through one
  all-gather; a locked block advances a peer's learner with bare
  methods_for calls (``_tick_block``);
- each round of num_processes blocks all-gathers its payloads, and
  process 0 writes them in serial order and keeps the index;
- inputs the scanner cannot pre-split (gzip, FASTA, multi-line records)
  take the replicated-parse path, host engine only.

``-e cuda`` hands whole waves to ``dist_cuda``.  The archive is
byte-identical to one process's for any process count.

    FQZ5_DIST_COORD=127.0.0.1:PORT FQZ5_DIST_NPROCS=N FQZ5_DIST_PID=P \\
    python -m fqzcomp5_tpu_torch.parallel.distributed [-d] [-LEVEL] \\
        [-b SIZE] [-e cuda|host] [--device DEV] in out [out2]

writes `out` from process 0.  ``-e cuda`` (the default) runs each rank
on ``cuda:{P % cards}``, and so does ``-e host`` with
``FQZ5_DEVICE_ADAPTIVE`` set, for its blocks' adaptive sections (as the
CLI's ``-e host`` does, ``FQZ5_DEVICE_ADAPTIVE_VERIFY`` included);
``FQZ5_DIST_LOCAL_MESH=DPxSP`` gives a rank a mesh of dp*sp slots from
that card on, wrapping round the visible cards.
``--device cpu`` runs the plain versions on the CPU instead (its local
mesh is dp*sp CPU slots); ``--device cuda:K`` starts at card K.
``FQZ5_DIST_STATS=1`` prints one JSON line of ``STATS`` at exit.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
from typing import BinaryIO

import torch

from fqzcomp5_tpu_torch import container, fastq
from fqzcomp5_tpu_torch.blocks import encode_block
from fqzcomp5_tpu_torch.cli import TPU_ENGINE_REFUSED, switch_on
from fqzcomp5_tpu_torch.constants import Section
from fqzcomp5_tpu_torch.learning import (MethodLearner, journal_dumps,
                                         journal_loads)
from fqzcomp5_tpu_torch.options import Options, method_avail_for

_SECS = (Section.NAME, Section.SEQ, Section.QUAL)

# per-process work accounting (FQZ5_DIST_STATS=1 prints it at exit):
# parse bytes and blocks show that each process parses only what it
# owns; work_cpu_s counts only parse and codec CPU, gather_s the wall
# seconds spent in the all-gathers
STATS = {"parse_bytes": 0, "blocks_encoded": 0, "blocks_ticked": 0,
         "work_cpu_s": 0.0, "gather_s": 0.0}


class _work_timer:
    def __enter__(self):
        self._t0 = time.process_time()

    def __exit__(self, *exc):
        STATS["work_cpu_s"] += time.process_time() - self._t0
        return False


def init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the gloo group at coordinator (host:port).  Rank 0 builds the
    native host library if it is missing before the warm-up all-gather,
    so that the other ranks only load it.  The warm-up sets up every
    pair of ranks now, while all are responsive, and not at the first
    real exchange, which may come while a peer is busy for minutes."""
    import torch.distributed as dist

    from fqzcomp5_tpu_torch.codecs import native

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if process_id == 0:
        native.lib()
    _allgather_bytes(b"")


def _allgather_bytes(mine: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process: the sizes
    first, then the blobs padded to the largest.  Wall seconds spent
    here accumulate in STATS["gather_s"]."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        n = dist.get_world_size()
        size = torch.tensor([len(mine)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        dist.all_gather(sizes, size)
        sizes = [int(s) for s in sizes]
        cap = max(max(sizes), 1)
        buf = torch.zeros(cap, dtype=torch.uint8)
        if mine:
            buf[:len(mine)] = torch.frombuffer(bytearray(mine),
                                               dtype=torch.uint8)
        bufs = [torch.empty(cap, dtype=torch.uint8) for _ in range(n)]
        dist.all_gather(bufs, buf)
        return [b[:s].numpy().tobytes() for b, s in zip(bufs, sizes)]
    finally:
        STATS["gather_s"] += time.perf_counter() - t0


def _gather_round(payloads: list[bytes | None], pid: int) -> list[bytes]:
    """All-gather one round's payloads (one owned block per process).
    Processes that own no block this round contribute an empty slot."""
    mine = payloads[pid] if pid < len(payloads) and \
        payloads[pid] is not None else b""
    return _allgather_bytes(mine)


def _tick_block(learner: MethodLearner, is_fasta: bool) -> None:
    """Advance the learner for a peer-owned locked block (encode_block's
    methods_for calls, exactly)."""
    learner.methods_for(Section.NAME)
    learner.methods_for(Section.SEQ)
    if not is_fasta:
        learner.methods_for(Section.QUAL)
    STATS["blocks_ticked"] += 1


class _Writer:
    """Rank 0's side of the rounds: blocks in serial order, the index."""

    def __init__(self, out_fp: BinaryIO | None, process_id: int):
        self.out_fp = out_fp
        self.pid = process_id
        self.idx = container.FileIndex()
        if process_id == 0:
            container.write_header(out_fp)

    def add(self, pay: bytes, meta: tuple[int, int]) -> None:
        """Write one block; meta: (uncompressed size, record count)."""
        self.idx.add(self.out_fp.tell(), *meta)
        self.out_fp.write(pay)

    def close(self) -> None:
        if self.pid == 0:
            index_offset = self.out_fp.tell()
            container.write_index(self.out_fp, self.idx)
            container.patch_index_offset(self.out_fp, index_offset)


def _flush_round(round_pay: list, round_meta: list, pid: int, emit) -> None:
    """Gather a round (a payload from each process that owns a block or a
    wave in it; None in the other slots of round_meta) and, on rank 0,
    hand each owner's payload and meta to emit(pay, meta) in process
    order; then clear the round.  A payload rank 0 already holds (its
    own, or a block every process encoded) is used as it is."""
    if not any(m is not None for m in round_meta):
        return
    gathered = _gather_round(round_pay, pid)
    if pid == 0:
        for p, meta in enumerate(round_meta):
            if meta is None:
                continue
            pay = round_pay[p] if round_pay[p] is not None else gathered[p]
            if not pay:
                raise RuntimeError(f"missing payload from process {p}")
            emit(pay, meta)
    round_pay[:] = [None] * len(round_pay)
    round_meta[:] = [None] * len(round_meta)


def encode_file_distributed(in_path: str, out_fp: BinaryIO | None,
                            arg: Options, *, process_id: int,
                            num_processes: int, engine: str = "host",
                            device=None) -> None:
    """Distributed encode; only process 0 writes to out_fp (pass None
    elsewhere).  engine "host" runs the host codecs a block at a time,
    "cuda" the wave engine on `device` (a torch.device or a Mesh; the
    CPU runs the plain versions).  Under "host", a device given is where
    each block's adaptive sections encode (blocks.encode_block).  The
    archive equals one process's."""
    if engine not in ("host", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    blocks = fastq.scan_blocks(in_path, arg.blk_size)
    if engine == "cuda":
        if blocks is None:
            raise ValueError(
                "engine=cuda distributed encode needs a scannable "
                "(plain, clean 4-line FASTQ) input")
        from fqzcomp5_tpu_torch.parallel.dist_cuda import \
            encode_file_dist_cuda

        encode_file_dist_cuda(in_path, out_fp, arg, blocks,
                              process_id=process_id,
                              num_processes=num_processes, device=device)
        return
    if blocks is None:
        _encode_replicated(in_path, out_fp, arg, process_id=process_id,
                           num_processes=num_processes, device=device)
        return

    learner = MethodLearner()
    learner.method_avail = method_avail_for(arg)
    w = _Writer(out_fp, process_id)
    round_pay: list[bytes | None] = [None] * num_processes
    round_meta: list[tuple[int, int] | None] = [None] * num_processes

    for serial, (start, end, nrec, seq_bytes) in enumerate(blocks):
        owner = serial % num_processes
        trial = any(learner.in_trial(s) or learner.will_reopen(s)
                    for s in _SECS)
        blob = b""
        if owner == process_id:
            with _work_timer():
                fq = fastq.parse_block_range(in_path, start, end)
                STATS["parse_bytes"] += end - start
                STATS["blocks_encoded"] += 1
                if trial:
                    learner.start_journal()
                round_pay[owner] = encode_block(learner, arg, fq,
                                                device=device)
                if trial:
                    blob = journal_dumps(learner.pop_journal())
        elif not trial:
            _tick_block(learner, is_fasta=False)
        if trial and num_processes > 1:
            # lock-step: the owner's trial stats reach every peer
            blobs = _allgather_bytes(blob)
            if owner != process_id:
                _tick_block(learner, is_fasta=False)
                learner.replay_journal(journal_loads(blobs[owner]))
        round_meta[owner] = (seq_bytes, nrec)
        if (serial + 1) % num_processes == 0:
            _flush_round(round_pay, round_meta, process_id, w.add)
    _flush_round(round_pay, round_meta, process_id, w.add)
    w.close()


def _encode_replicated(in_path: str, out_fp: BinaryIO | None,
                       arg: Options, *, process_id: int,
                       num_processes: int, device=None) -> None:
    """For inputs the scanner cannot pre-split (gzip, FASTA, multi-line
    records): every process parses the whole stream, so block
    boundaries and serials agree everywhere; trial blocks are encoded
    by every process to keep the learners in lock-step."""
    learner = MethodLearner()
    learner.method_avail = method_avail_for(arg)
    parser = fastq.Parser(fastq.open_input(in_path))
    w = _Writer(out_fp, process_id)
    serial = 0
    round_pay: list[bytes | None] = [None] * num_processes
    round_meta: list[tuple[int, int] | None] = [None] * num_processes

    while True:
        with _work_timer():
            fq = parser.next_batch(arg.blk_size)
        if fq is None or fq.num_records == 0:
            break
        STATS["parse_bytes"] += (len(fq.name_buf) + len(fq.seq_buf)
                                 + len(fq.qual_buf))
        owner = serial % num_processes
        redundant = any(learner.in_trial(s) or learner.will_reopen(s)
                        for s in _SECS)
        if redundant or owner == process_id:
            with _work_timer():
                pay = encode_block(learner, arg, fq, device=device)
            STATS["blocks_encoded"] += 1
            # a redundant block's bytes are the same everywhere: the
            # writer keeps its own copy
            if not redundant or process_id == 0:
                round_pay[owner] = pay
        else:
            _tick_block(learner, fq.is_fasta)
        round_meta[owner] = (len(fq.seq_buf), fq.num_records)
        serial += 1
        if serial % num_processes == 0:
            _flush_round(round_pay, round_meta, process_id, w.add)
    _flush_round(round_pay, round_meta, process_id, w.add)
    w.close()


def decode_file_distributed(in_path: str, out_fp: BinaryIO | None,
                            arg: Options, *, process_id: int,
                            num_processes: int,
                            out_fp2: BinaryIO | None = None,
                            paired: bool | None = None) -> None:
    """Distributed decode on the host: blocks round-robin by serial,
    each owner reads its blocks through the file index (a peer's blocks
    are skipped, not read), decodes and formats them, and the FASTQ
    text all-gathers a round at a time to process 0, which writes it in
    serial order.  Pass out_fp2 (or paired=True off rank 0) for paired
    output; the two halves travel length-prefixed."""
    from fqzcomp5_tpu_torch.blocks import decode_block
    from fqzcomp5_tpu_torch.drivers import (make_deinterleave_writer,
                                            make_fastq_writer)

    # only process 0 has real file handles, so every process must be
    # told the format
    if paired is None:
        paired = out_fp2 is not None
    if paired:
        writer = make_deinterleave_writer(out_fp, out_fp2, arg)

        def fmt(fq):
            r1, r2 = writer.format(fq)
            return struct.pack("<Q", len(r1)) + r1 + r2

        def emit(pay, _meta):
            n1 = struct.unpack("<Q", pay[:8])[0]
            out_fp.write(pay[8:8 + n1])
            out_fp2.write(pay[8 + n1:])
    else:
        fmt = make_fastq_writer(out_fp, arg).format

        def emit(pay, _meta):
            out_fp.write(pay)

    round_pay: list[bytes | None] = [None] * num_processes
    round_meta: list[bool | None] = [None] * num_processes

    def flush_round():
        _flush_round(round_pay, round_meta, process_id, emit)

    def handle(serial, read_raw):
        owner = serial % num_processes
        if owner == process_id:
            with _work_timer():
                raw = read_raw()
                STATS["parse_bytes"] += len(raw)
                fq = decode_block(raw, file_version)
                STATS["blocks_encoded"] += 1
                round_pay[owner] = fmt(fq)
        round_meta[owner] = True

    with open(in_path, "rb") as in_fp:
        file_version, index_offset = container.read_header(in_fp)
        idx = (container.read_index(in_fp, index_offset)
               if index_offset else None)

        def reader_for(entry):
            def read_raw():
                in_fp.seek(entry.offset)
                szb = in_fp.read(4)
                (bsz,) = struct.unpack("<I", szb)
                return szb + in_fp.read(bsz)
            return read_raw

        if idx is not None:
            # owners read only their blocks
            for serial, entry in enumerate(idx.entries):
                handle(serial, reader_for(entry))
                if (serial + 1) % num_processes == 0:
                    flush_round()
        else:
            for serial, raw in enumerate(
                    container.iter_raw_blocks(in_fp, index_offset)):
                handle(serial, lambda raw=raw: raw)
                if (serial + 1) % num_processes == 0:
                    flush_round()
        flush_round()


def _parse_argv(argv):
    """(arg, decode, engine, device, files) of the entry's arguments."""
    arg = Options()
    files = []
    decode = False
    engine = "cuda"
    device = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-d":
            decode = True
        elif a.startswith("-") and len(a) == 2 and a[1].isdigit():
            arg.apply_preset(int(a[1]))
        elif a == "-b":
            i += 1
            arg.blk_size = int(argv[i])
        elif a == "-e":
            i += 1
            engine = argv[i]
            if engine == "tpu":
                raise ValueError(TPU_ENGINE_REFUSED)
            if engine not in ("cuda", "host"):
                raise ValueError(f"unknown engine '{engine}'")
        elif a == "--device":
            i += 1
            device = argv[i]
        else:
            files.append(a)
        i += 1
    if len(files) not in (2, 3):
        raise ValueError("usage: [-d] [-LEVEL] [-b SIZE] [-e cuda|host] "
                         "[--device DEV] in out [out2]")
    arg.verbose = -1
    return arg, decode, engine, device, files


def _rank_device(device: str | None, pid: int, mesh_env: str | None,
                 what: str = "-e cuda"):
    """The device (or local Mesh) of rank pid under -e cuda, or -e host
    with FQZ5_DEVICE_ADAPTIVE (`what`): --device cpu gives the CPU (a
    mesh of CPU slots); otherwise card K of --device cuda:K, or card
    pid % cards, and a mesh's slots go on from it round the visible
    cards.  Raises ValueError when no card is visible."""
    from fqzcomp5_tpu_torch.parallel.pipeline import make_mesh

    base = torch.device(device) if device else torch.device("cuda")
    if base.type not in ("cpu", "cuda"):
        raise ValueError(f"--device {device}: the entry runs on cuda or cpu")
    n = 1
    if base.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"{what} needs a CUDA device, and none is "
                             "visible (--device cpu runs the plain versions)")
        ncards = torch.cuda.device_count()
        first = base.index if base.index is not None else pid % ncards
    if mesh_env:
        dp, sp = (int(x) for x in mesh_env.lower().split("x"))
        n = dp * sp
    if base.type == "cpu":
        devs = [base] * n
    else:
        devs = [torch.device("cuda", (first + k) % ncards) for k in range(n)]
    return make_mesh(devs, dp=dp, sp=sp) if mesh_env else devs[0]


def main(argv=None) -> int:
    """Entry of one rank: FQZ5_DIST_COORD / _NPROCS / _PID and the
    arguments above; out is written by process 0 only.  A usage error,
    -e tpu and an encode without the card it needs end every rank with
    ERROR: and exit 1 before the group is joined, so no rank waits on
    another.  -d decodes on the host, as the JAX package's does."""
    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    pid = int(os.environ["FQZ5_DIST_PID"])
    nprocs = int(os.environ["FQZ5_DIST_NPROCS"])
    try:
        arg, decode, engine, device, files = _parse_argv(argv)
        arg.verify_device = int(switch_on("FQZ5_DEVICE_ADAPTIVE_VERIFY"))
        dev = None
        if not decode and (engine == "cuda"
                           or switch_on("FQZ5_DEVICE_ADAPTIVE")):
            dev = _rank_device(
                device, pid, os.environ.get("FQZ5_DIST_LOCAL_MESH"),
                "-e cuda" if engine == "cuda"
                else "-e host with FQZ5_DEVICE_ADAPTIVE")
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    init(os.environ["FQZ5_DIST_COORD"], nprocs, pid)

    import torch.distributed as dist

    in_path, out_path = files[0], files[1]
    out2_path = files[2] if len(files) > 2 else None
    out_fp = open(out_path, "wb") if pid == 0 else None
    out_fp2 = open(out2_path, "wb") if pid == 0 and out2_path else None
    try:
        if decode:
            decode_file_distributed(in_path, out_fp, arg, process_id=pid,
                                    num_processes=nprocs, out_fp2=out_fp2,
                                    paired=out2_path is not None)
        else:
            encode_file_distributed(in_path, out_fp, arg, process_id=pid,
                                    num_processes=nprocs, engine=engine,
                                    device=dev)
    except (ValueError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    finally:
        for f in (out_fp, out_fp2):
            if f:
                f.close()
        dist.destroy_process_group()
    if os.environ.get("FQZ5_DIST_STATS", "0") not in ("", "0"):
        print(json.dumps({
            "dist_stat": pid,
            "cpu_s": round(time.process_time(), 3),
            "wall_s": round(time.perf_counter() - t_start, 3),
            **STATS}), flush=True)
    return 0


if __name__ == "__main__":
    # run the imported module's main, so that dist_cuda and this entry
    # share one STATS
    from fqzcomp5_tpu_torch.parallel import distributed

    raise SystemExit(distributed.main())
