"""File-level encode/decode pipelines.

Equivalent to the reference stream drivers (encode_gzip
fqzcomp5.c:2980-3208, encode_interleaved :3211-3439, decode :3753-3908
and the (de)interleaved/gzip variants).  The reference's thread pool
with serial-ordered results (thread_pool.c) is replaced by a
ThreadPoolExecutor whose futures are drained in submission order —
block payloads are independent, so output is byte-identical regardless
of worker count.  Given a device, the encoders send each block's
adaptive sections there (blocks.encode_block), one job at a time from
each worker thread.
"""

from __future__ import annotations

import concurrent.futures as cf
from fqzcomp5_tpu_torch.utils import lightclass as dataclasses  # noqa: N813 — see lightclass.py
import os
import sys
import time
# typing import dropped: costs ~12ms of CLI cold-start; all uses
# are string annotations (from __future__ import annotations)

from fqzcomp5_tpu_torch import container, fastq
from fqzcomp5_tpu_torch.blocks import decode_block, encode_block
from fqzcomp5_tpu_torch.constants import Section, VERS_V10, VERS_V11
from fqzcomp5_tpu_torch.learning import MethodLearner
from fqzcomp5_tpu_torch.options import Options, method_avail_for


@dataclasses.dataclass
class Timings:
    """Per-section size/time accounting (fqzcomp5.c:1815-1884).

    Columns follow update_stats: 0=name 1=seq 2=qual 3=length; times in
    seconds (the reference stores µs).  The wave engine
    (cuda_driver.encode_wave_blocks) encodes a wave's blocks together:
    a block's name seconds are its own, its seq and qual seconds its
    share, by section bytes, of the host wall of its wave's seq or qual
    segment tasks (waits for the device included)."""

    nblock: int = 0
    nusize: int = 0
    ncsize: int = 0
    ntime: float = 0.0
    lusize: int = 0
    lcsize: int = 0
    ltime: float = 0.0
    susize: int = 0
    scsize: int = 0
    stime: float = 0.0
    qusize: int = 0
    qcsize: int = 0
    qtime: float = 0.0
    nmeth: int = 0
    smeth: int = 0
    qmeth: int = 0
    lmeth: int = 0

    def note_methods(self, n, s, q):
        self.nmeth, self.smeth, self.qmeth = n, s, q

    def update(self, column: int, usize: int, csize: int, dt: float):
        """update_stats (fqzcomp5.c:1830-1854)."""
        if column == 0:
            self.nusize += usize
            self.ncsize += csize
            self.ntime += dt
        elif column == 1:
            self.susize += usize
            self.scsize += csize
            self.stime += dt
        elif column == 2:
            self.qusize += usize
            self.qcsize += csize
            self.qtime += dt
        elif column == 3:
            self.lusize += usize
            self.lcsize += csize
            self.ltime += dt

    def append_block(self, o: "Timings", verbose: int, fp=None):
        """append_timings (fqzcomp5.c:1856-1884): merge a per-block
        Timings and optionally print the per-block trace."""
        self.nblock += 1
        self.nusize += o.nusize
        self.ncsize += o.ncsize
        self.ntime += o.ntime
        self.susize += o.susize
        self.scsize += o.scsize
        self.stime += o.stime
        self.qusize += o.qusize
        self.qcsize += o.qcsize
        self.qtime += o.qtime
        self.lusize += o.lusize
        self.lcsize += o.lcsize
        self.ltime += o.ltime
        if verbose > 0:
            fp = fp if fp is not None else sys.stderr
            print(f"Names   {o.nusize:11d} to {o.ncsize:11d} "
                  f"in {o.ntime:.2f} sec method {o.nmeth}", file=fp)
            print(f"Lengths {o.lusize:11d} to {o.lcsize:11d} "
                  f"in {o.ltime:.2f} sec method {o.lmeth}", file=fp)
            print(f"Seqs    {o.susize:11d} to {o.scsize:11d} "
                  f"in {o.stime:.2f} sec method {o.smeth}", file=fp)
            print(f"Quals   {o.qusize:11d} to {o.qcsize:11d} "
                  f"in {o.qtime:.2f} sec method {o.qmeth}\n", file=fp)

    def report(self, fp=None):
        fp = fp if fp is not None else sys.stderr
        print(f"All {self.nblock} blocks combined:", file=fp)
        print(f"Names    {self.nusize:10d} to {self.ncsize:10d} "
              f"in {self.ntime:.2f} sec", file=fp)
        print(f"Lengths  {self.lusize:10d} to {self.lcsize:10d}", file=fp)
        print(f"Seqs     {self.susize:10d} to {self.scsize:10d} "
              f"in {self.stime:.2f} sec", file=fp)
        print(f"Qual     {self.qusize:10d} to {self.qcsize:10d} "
              f"in {self.qtime:.2f} sec", file=fp)


def _make_learner(arg: Options) -> MethodLearner:
    learner = MethodLearner()
    learner.method_avail = method_avail_for(arg)
    return learner


def _encode_stream(batches, out_fp: BinaryIO, arg: Options, t: Timings,
                   device=None) -> None:
    """Encode the blocks of `batches` on a pool of arg.nthread threads;
    device (a torch.device or a Mesh; None: the host codecs) is where
    each block's adaptive sections encode (blocks.encode_block)."""
    container.write_header(out_fp)
    learner = _make_learner(arg)
    idx = container.FileIndex()

    nthread = max(1, arg.nthread)

    def job(fq):
        bt = Timings()
        blk = encode_block(learner, arg, fq, bt, device)
        return blk, fq, bt

    if nthread == 1 and (os.cpu_count() or 1) == 1:
        # One worker on one core: parse/encode overlap can't win, the
        # executor + queue handoffs only add GIL switches.  Run inline.
        for fq in batches:
            if fq is None or fq.num_records == 0:
                break
            blk, fq, bt = job(fq)
            idx.add(out_fp.tell(), len(fq.seq_buf), fq.num_records)
            out_fp.write(blk)
            t.append_block(bt, arg.verbose)
        index_offset = out_fp.tell()
        container.write_index(out_fp, idx)
        container.patch_index_offset(out_fp, index_offset)
        return

    with cf.ThreadPoolExecutor(max_workers=nthread) as pool:
        pending = []
        max_inflight = nthread * 2

        def drain_one():
            blk, fq, bt = pending.pop(0).result()
            idx.add(out_fp.tell(), len(fq.seq_buf), fq.num_records)
            out_fp.write(blk)
            t.append_block(bt, arg.verbose)

        for fq in batches:
            if fq is None or fq.num_records == 0:
                break
            pending.append(pool.submit(job, fq))
            while len(pending) >= max_inflight:
                drain_one()
        while pending:
            drain_one()

    index_offset = out_fp.tell()
    container.write_index(out_fp, idx)
    container.patch_index_offset(out_fp, index_offset)


def _prefetched(gen, depth: int = 2):
    """Run a batch generator on a background thread (the reference
    overlaps its main-thread kseq parse with pool compression; this is
    the same overlap — parsing is numpy/native work that releases the
    GIL).  On a single-core machine overlap can't win; yield inline."""
    if (os.cpu_count() or 1) == 1:
        yield from gen
        return
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()
    err: list[BaseException] = []

    def run():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(DONE)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        yield item
    th.join()
    if err:
        raise err[0]


def encode_file(in_path: Optional[str], out_fp: BinaryIO, arg: Options,
                t: Timings, device=None) -> None:
    parser = fastq.Parser(fastq.open_input(in_path))

    def batches():
        while True:
            b = parser.next_batch(arg.blk_size)
            if b is None:
                return
            yield b

    _encode_stream(_prefetched(batches()), out_fp, arg, t, device)


def encode_paired(in1: str, in2: str, out_fp: BinaryIO, arg: Options,
                  t: Timings, device=None) -> None:
    parser = fastq.InterleavedParser(
        fastq.open_input(in1), fastq.open_input(in2))

    def batches():
        while True:
            b = parser.next_batch(arg.blk_size)
            if b is None:
                return
            yield b

    _encode_stream(_prefetched(batches()), out_fp, arg, t, device)


def decode_file(in_fp: BinaryIO, writer, arg: Options, t: Timings) -> None:
    """Decode all blocks; `writer(batch)` emits output in order."""
    file_version, index_offset = container.read_header(in_fp)
    if file_version not in (VERS_V11, VERS_V10):
        # headerless legacy: VERS_HEADERLESS rewinds; still block stream
        pass

    nthread = max(1, arg.nthread)
    fmt = getattr(writer, "format", None)
    sink = getattr(writer, "write_bytes", None)

    def job(raw):
        bt = Timings()
        fq = decode_block(raw, file_version, timings=bt)
        if fmt is not None:
            # format in the worker too; the ordered drain just writes
            return fmt(fq), bt
        return fq, bt

    if nthread == 1 and (os.cpu_count() or 1) == 1:
        # see _encode_stream: no overlap to win on one core
        for raw in container.iter_raw_blocks(in_fp, index_offset):
            res, bt = job(raw)
            t.append_block(bt, arg.verbose)
            if fmt is not None:
                sink(res)
            else:
                writer(res)
        return

    with cf.ThreadPoolExecutor(max_workers=nthread) as pool:
        pending = []
        max_inflight = nthread * 2

        def drain_one():
            res, bt = pending.pop(0).result()
            t.append_block(bt, arg.verbose)
            if fmt is not None:
                sink(res)
            else:
                writer(res)

        for raw in container.iter_raw_blocks(in_fp, index_offset):
            pending.append(pool.submit(job, raw))
            while len(pending) >= max_inflight:
                drain_one()
        while pending:
            drain_one()


class _FastqWriter:
    """Formatter + ordered sink pair: decode workers call .format in
    parallel, the in-order drain calls .write_bytes.  Calling the
    object directly does both (wave/TPU driver path)."""

    def __init__(self, out_fp: BinaryIO, arg: Options):
        self._out = out_fp
        self._plus = bool(arg.plus_name)

    def format(self, batch) -> bytes:
        from fqzcomp5_tpu_torch.fastq_fast import format_fastq_fast

        if batch.is_fasta:
            return fastq.format_fasta(batch)
        return format_fastq_fast(batch, self._plus)

    def write_bytes(self, data: bytes) -> None:
        self._out.write(data)

    def __call__(self, batch) -> None:
        self.write_bytes(self.format(batch))


def make_fastq_writer(out_fp: BinaryIO, arg: Options):
    return _FastqWriter(out_fp, arg)


class _DeinterleaveWriter:
    def __init__(self, out1: BinaryIO, out2: BinaryIO, arg: Options):
        self._o1, self._o2 = out1, out2
        self._plus = arg.plus_name

    def format(self, batch) -> tuple[bytes, bytes]:
        r1, r2 = fastq.split_batch(batch)
        if batch.is_fasta:
            return fastq.format_fasta(r1), fastq.format_fasta(r2)
        return (fastq.format_fastq(r1, self._plus),
                fastq.format_fastq(r2, self._plus))

    def write_bytes(self, pair) -> None:
        self._o1.write(pair[0])
        self._o2.write(pair[1])

    def __call__(self, batch) -> None:
        self.write_bytes(self.format(batch))


def make_deinterleave_writer(out1: BinaryIO, out2: BinaryIO, arg: Options):
    return _DeinterleaveWriter(out1, out2, arg)
