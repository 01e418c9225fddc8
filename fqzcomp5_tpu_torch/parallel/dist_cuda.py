"""The wave engine (cuda_driver) under multi-process torch.distributed.

The counterpart of the JAX package's ``parallel/dist_tpu.py``.  Waves,
not single blocks, go round-robin over the processes: wave w is owned
by process w % N.  The owner parses its wave's byte ranges
(fastq.scan_blocks; parse once, as the host path does), runs the whole
wave engine on its device or local mesh
(cuda_driver.encode_wave_blocks: the batched rANS walks, the
cross-block adaptive batch and the method learner), and the serialized
blocks all-gather to process 0 a round of N waves at a time.

Learner lock-step without repeated codec work: every process decides,
from its own learner state and so identically everywhere, whether a
wave can hold trial activity (a section in trial, or a review that
re-opens within the wave: learning.review_remaining).  For such a wave
the owner's trial journal is all-gathered, and the peers replay it
through the methods_for calls the wave engine made
(``_tick_section_wave`` follows cuda_driver._section_tasks); a locked
wave ticks bare methods_for calls with no exchange.

The archive is byte-identical to one process's ``-e cuda`` encode, and
so to ``fqzcomp5_tpu -e tpu``'s, for any process count.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from fqzcomp5_tpu_torch import fastq
from fqzcomp5_tpu_torch.constants import Section
from fqzcomp5_tpu_torch.learning import (MethodLearner, journal_dumps,
                                         journal_loads)
from fqzcomp5_tpu_torch.options import Options, method_avail_for
from fqzcomp5_tpu_torch.parallel.distributed import (STATS, _Writer,
                                                     _allgather_bytes,
                                                     _flush_round,
                                                     _work_timer)

# section-wave order in cuda_driver.encode_wave_blocks; NAME ticks per
# block afterwards
_WAVE_SECS = (Section.SEQ, Section.QUAL)


def _tick_section_wave(learner: MethodLearner, sec: int, n: int,
                       journal_q: list) -> None:
    """Advance one section's learner for a peer-owned wave of n blocks,
    replaying the owner's trial stats: the methods_for / record_trial
    sequence of cuda_driver._section_tasks and _SegmentTask.plan."""
    bi = 0
    while bi < n:
        mask = learner.methods_for(sec)
        if learner.in_trial(sec):
            take = min(learner.trial_remaining(sec), n - bi)
            for _ in range(take - 1):
                learner.methods_for(sec)
            for _ in range(take):
                if not journal_q:
                    raise RuntimeError(f"journal underrun for section {sec}")
                learner.record_trial(sec, journal_q.pop(0))
            bi += take
        else:
            seg = 1
            while bi + seg < n and not learner.will_reopen(sec):
                if learner.methods_for(sec) != mask:
                    break
                seg += 1
            bi += seg


def _tick_wave(learner: MethodLearner, n: int, journal: list) -> None:
    """Advance the whole learner for a peer-owned wave (the SEQ and QUAL
    section-waves, then NAME a block at a time), replaying the owner's
    journal: (sec, sizes) entries in record order."""
    by_sec: dict[int, list] = {}
    for sec, sizes in journal:
        by_sec.setdefault(int(sec), []).append(sizes)
    for sec in _WAVE_SECS:
        _tick_section_wave(learner, int(sec), n, by_sec.get(int(sec), []))
    nq = by_sec.get(int(Section.NAME), [])
    for _ in range(n):
        learner.methods_for(Section.NAME)
        if learner.in_trial(Section.NAME):
            if not nq:
                raise RuntimeError("journal underrun for NAME")
            learner.record_trial(Section.NAME, nq.pop(0))


def _wave_needs_sync(learner: MethodLearner, n: int) -> bool:
    """True when a wave of n blocks can produce trial stats (decided from
    the lock-step learner state, so every process agrees)."""
    return any(learner.in_trial(s) or learner.review_remaining(s) <= n
               for s in (Section.NAME, Section.SEQ, Section.QUAL))


def encode_file_dist_cuda(in_path: str, out_fp: BinaryIO | None,
                          arg: Options, blocks, *, process_id: int,
                          num_processes: int, device) -> None:
    """blocks: fastq.scan_blocks output; device: this process's
    torch.device or local Mesh.  Only process 0 writes."""
    from fqzcomp5_tpu_torch.cuda_driver import (encode_wave_blocks,
                                                wave_groups_from_sizes)

    learner = MethodLearner()
    learner.method_avail = method_avail_for(arg)
    w = _Writer(out_fp, process_id)

    # the same waves everywhere, from the scan alone (clean 4-line
    # FASTQ: qual bytes equal seq bytes)
    waves = []
    base = 0
    for g in wave_groups_from_sizes([2 * b[3] for b in blocks]):
        waves.append(blocks[base:base + g])
        base += g

    round_pay: list[bytes | None] = [None] * num_processes
    round_meta: list[list | None] = [None] * num_processes

    def add_wave(blob: bytes, meta: list) -> None:
        """Write a wave's length-prefixed blocks; meta: their (uncompressed
        size, record count)s."""
        off = 0
        for m in meta:
            (blen,) = struct.unpack_from("<I", blob, off)
            off += 4
            w.add(blob[off:off + blen], m)
            off += blen
        if off != len(blob):
            raise RuntimeError("wave blob framing mismatch")

    for wi, wblocks in enumerate(waves):
        owner = wi % num_processes
        needs_sync = _wave_needs_sync(learner, len(wblocks))
        jblob = b""
        if owner == process_id:
            with _work_timer():
                batch = [fastq.parse_block_range(in_path, b[0], b[1])
                         for b in wblocks]
                STATS["parse_bytes"] += sum(b[1] - b[0] for b in wblocks)
                STATS["blocks_encoded"] += len(wblocks)
                learner.start_journal()
                enc = encode_wave_blocks(learner, arg, batch, device)
                journal = learner.pop_journal()
            if needs_sync:
                jblob = journal_dumps(journal)
            round_pay[owner] = b"".join(
                struct.pack("<I", len(blk)) + blk for blk, _bt in enc)
        if needs_sync and num_processes > 1:
            blobs = _allgather_bytes(jblob)
            if owner != process_id:
                _tick_wave(learner, len(wblocks), journal_loads(blobs[owner]))
                STATS["blocks_ticked"] += len(wblocks)
        elif owner != process_id:
            _tick_wave(learner, len(wblocks), [])
            STATS["blocks_ticked"] += len(wblocks)
        round_meta[owner] = [(b[3], b[2]) for b in wblocks]
        if (wi + 1) % num_processes == 0:
            _flush_round(round_pay, round_meta, process_id, add_wave)
    _flush_round(round_pay, round_meta, process_id, add_wave)
    w.close()
