"""Wave-batched file pipelines of the port (the ``-e cuda`` engine).

A port of the JAX package's ``tpu_driver`` main path.  Blocks gather
into waves; each wave replays the reference's trial/lock/review method
learner block by block, but batches every segment's rANS work into
cross-block device walks: order-0, order-1, PACK and STRIPE candidates
of every seq and qual section of at least MIN_DEVICE bytes walk on the
given torch device, and only the winners' words are copied back.
The adaptive SEQ*/FQZ* candidates of every section of at least
MIN_DEVICE bytes encode on the device too, batched across the segment's
blocks (``ops.adaptive_batch``), so every preset (-1..-9, the default,
-s/-S/-q/-Q) runs here.  Names, LZP3 and small sections stay on the
host, as in the JAX engine.  Archives are byte-identical to
``fqzcomp5_tpu -e tpu``.

Every entry takes a ``mesh.Mesh`` where it takes a device and passes
it down unchanged: the walks split their streams over it, and the
archive's bytes stay the same.

A device error propagates: nothing here falls back to the host codecs.
Only two routes take them, both codec decisions: sections under
MIN_DEVICE, and a job the fqz codec declines (a quality alphabet of 96
symbols or more gives no payload, and the method is skipped).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import struct
import time
import zlib
from typing import BinaryIO

import numpy as np
import torch

from fqzcomp5_tpu_torch import container, fastq
from fqzcomp5_tpu_torch.blocks import (_SEQ_PARAMS, compress_with_methods,
                                       decode_block)
from fqzcomp5_tpu_torch.codecs import host
from fqzcomp5_tpu_torch.constants import Method, Section, VERS_V11, bit
from fqzcomp5_tpu_torch.drivers import Timings
from fqzcomp5_tpu_torch.learning import MethodLearner
from fqzcomp5_tpu_torch.options import Options, method_avail_for
from fqzcomp5_tpu_torch.utils import varint
from fqzcomp5_tpu_torch.engine_cuda import (decode_o0_batch,
                                            decode_o1_batch,
                                            encode_o0_batch_lazy,
                                            encode_o1_batch_lazy)
from fqzcomp5_tpu_torch.ops import adaptive_batch, devtimer
from fqzcomp5_tpu_torch.ops import backend as _bk
from fqzcomp5_tpu_torch.mesh import Mesh

MIN_DEVICE = 4096   # sections smaller than this stay on the host


def wave_blocks() -> int:
    """Max blocks per wave: FQZ5_WAVE_BLOCKS (default 16), read at each
    call."""
    return int(os.environ.get("FQZ5_WAVE_BLOCKS", "16"))


def wave_budget() -> int:
    """A wave flushes when its seq+qual bytes reach this budget (or at
    wave_blocks() blocks): FQZ5_WAVE_MB x 1e6 bytes (default 128), read
    at each call.  -1's 10 MB blocks batch many to a wave, -3's 100 MB
    blocks two to a wave."""
    return int(float(os.environ.get("FQZ5_WAVE_MB", "128")) * 1e6)


def wave_groups_from_sizes(sq_sizes: list[int]) -> list[int]:
    """Wave lengths for a stream of blocks with the given seq+qual
    byte sizes."""
    nmax, budget = wave_blocks(), wave_budget()
    groups = []
    n = acc = 0
    for s in sq_sizes:
        n += 1
        acc += s
        if n >= nmax or acc >= budget:
            groups.append(n)
            n = acc = 0
    if n:
        groups.append(n)
    return groups


X_PACK = 0x80
X_32 = 0x04
X_STRIPE = 0x08
X_NOSZ = 0x10
X_CAT = 0x20

_RANS_FAMILY = 0x3FE  # method bits 1..9: RANS0..RANSXN1
_TRIED_BITS = 0x7FFFFFFE  # method bits 1..30: what compress_with_methods tries
_FQZ_METHODS = (Method.FQZ0, Method.FQZ1, Method.FQZ2, Method.FQZ3,
                Method.FQZ4)


def _frame(order: int, data_len: int, payload: bytes) -> bytes:
    return bytes([order]) + varint.put_u32(data_len) + payload


_SHIFTS = {2: np.arange(0, 8, 4, dtype=np.uint8),
           4: np.arange(0, 8, 2, dtype=np.uint8),
           8: np.arange(8, dtype=np.uint8)}


def pack_np(data: bytes):
    """Vectorised PACK transform (pack.c:56-150 semantics).

    Returns (meta_bytes, packed_bytes, per_byte) or None when the
    alphabet exceeds 16 symbols.  Pad bits are zero."""
    arr = np.frombuffer(data, np.uint8)
    syms = np.flatnonzero(np.bincount(arr, minlength=256)
                          ).astype(np.uint8)
    n = len(syms)
    if n > 16:
        return None
    meta = bytes([n & 0xFF]) + syms.tobytes()
    if n <= 1:
        return meta, b"", 0
    per = 8 if n <= 2 else 4 if n <= 4 else 2
    lut = np.zeros(256, np.uint8)
    lut[syms] = np.arange(n, dtype=np.uint8)
    m = lut[arr]
    pad = (-len(m)) % per
    if pad:
        m = np.concatenate([m, np.zeros(pad, np.uint8)])
    mm = m.reshape(-1, per)
    packed = np.bitwise_or.reduce(mm << _SHIFTS[per], axis=1)
    return meta, packed.astype(np.uint8).tobytes(), per


def unpack_np(packed: bytes, out_len: int, syms: np.ndarray) -> bytes:
    """Inverse of pack_np for a known symbol map."""
    n = len(syms)
    if n <= 1:
        return syms.tobytes() * out_len if n else b""
    per = 8 if n <= 2 else 4 if n <= 4 else 2
    arr = np.frombuffer(packed, np.uint8)
    bits = 8 // per
    vals = (arr[:, None] >> _SHIFTS[per][None, :]) & ((1 << bits) - 1)
    return syms[vals.reshape(-1)[:out_len]].tobytes()


def stripe_split(data: bytes, N: int) -> list[bytes]:
    """Byte-transpose into N sub-streams (rANS_static4x16pr.c stripe
    layout): stripe j gets bytes j, j+N, j+2N, ...; the remainder goes
    one byte each to the first ulen%N stripes."""
    arr = np.frombuffer(data, np.uint8)
    ulen = len(arr)
    full = ulen - ulen % N
    rect = arr[:full].reshape(-1, N).T
    tail = arr[full:]
    outs = []
    for j in range(N):
        if j < len(tail):
            outs.append(np.concatenate([rect[j], tail[j:j + 1]])
                        .tobytes())
        else:
            outs.append(rect[j].tobytes())
    return outs


class _RansWave:
    """Staged best-of {O0, O1, PACK|O0, PACK|O1, STRIPE(readlen)} x32
    encode of one segment's sections.

      __init__  launches every candidate walk on the device;
      plan()    reads the sizes (one int32 per stream), picks each
                section's winner and its framed length;
      prefetch(winners) / assemble(winners) copy back and frame only the
                sections whose method competition rANS won.

    fixed_lens[i] > 1 enables the STRIPE candidate (per-read-position
    sub-streams)."""

    def __init__(self, datas: list[bytes], fixed_lens: list[int] | None,
                 device: torch.device | Mesh):
        self.datas = datas
        self.out_host: dict[int, bytes] = {}
        self.big_idx = [i for i, d in enumerate(datas)
                        if len(d) >= MIN_DEVICE]
        big = set(self.big_idx)
        for i, d in enumerate(datas):
            if i not in big:
                devtimer.count("candidate_bytes", len(d))
                self.out_host[i] = host.rans_compress(d, 1)
        if not self.big_idx:
            return
        with devtimer.span("prep/pack"):
            self.packs = [pack_np(datas[i]) for i in self.big_idx]
        jobs = [datas[i] for i in self.big_idx]
        self.pk_pos = {}
        for k, p in enumerate(self.packs):
            if p is not None and len(p[1]) >= 32:
                self.pk_pos[k] = len(jobs)
                jobs.append(p[1])
        self.st_pos = {}
        self.st_stripes = {}
        sjobs = []   # stripes walk separately: their lengths are ~1/N
        # of the sections', so mixing them would pad every stream to
        # the longest job's step count
        if fixed_lens is not None:
            with devtimer.span("prep/stripe"):
                for k, i in enumerate(self.big_idx):
                    N = fixed_lens[i] if i < len(fixed_lens) else 0
                    if 1 < N <= 255 and len(datas[i]) // N >= 64:
                        stripes = stripe_split(datas[i], N)
                        self.st_pos[k] = len(sjobs)
                        self.st_stripes[k] = stripes
                        sjobs.extend(stripes)
        # every stream walks at order 0 and at order 1
        devtimer.count("candidate_bytes",
                       2 * (sum(map(len, jobs)) + sum(map(len, sjobs))))
        with devtimer.span("prep/o0"):
            self.enc0 = encode_o0_batch_lazy(jobs, device)
        with devtimer.span("prep/o1"):
            self.enc1 = encode_o1_batch_lazy(jobs, device)
        self.senc0 = self.senc1 = None
        if sjobs:
            with devtimer.span("prep/o0"):
                self.senc0 = encode_o0_batch_lazy(sjobs, device)
            with devtimer.span("prep/o1"):
                self.senc1 = encode_o1_batch_lazy(sjobs, device)

    def plan(self) -> list[int]:
        """Per-section framed payload length (aligned with datas)."""
        if self.big_idx:
            self._plan_big()
        lens = [0] * len(self.datas)
        for i, p in self.out_host.items():
            lens[i] = len(p)
        for k, i in enumerate(self.big_idx):
            lens[i] = self.plan_lens[k]
        return lens

    def _plan_big(self) -> None:
        s0, s1 = self.enc0.sizes, self.enc1.sizes
        ss0 = self.senc0.sizes if self.senc0 else []
        ss1 = self.senc1.sizes if self.senc1 else []
        self.plans = []
        self.plan_lens = []
        for k, i in enumerate(self.big_idx):
            d = self.datas[i]
            # insertion order breaks size ties
            cands = [(s0[k], X_32 | 0, b"", 0, k),
                     (s1[k], X_32 | 1, b"", 1, k)]
            if k in self.pk_pos:
                meta, packed, _ = self.packs[k]
                pmeta = meta + varint.put_u32(len(packed))
                j = self.pk_pos[k]
                cands.append((len(pmeta) + s0[j],
                              X_PACK | X_32 | 0, pmeta, 0, j))
                cands.append((len(pmeta) + s1[j],
                              X_PACK | X_32 | 1, pmeta, 1, j))
            cands.sort(key=lambda c: c[0])
            clen, order, pmeta, which, j = cands[0]
            if clen >= len(d):  # CAT fallback (dispatcher rule)
                plan = ("cat", None, None, None)
                plan_len = 1 + len(varint.put_u32(len(d))) + len(d)
            else:
                plan = ("plain", order, pmeta, (which, j))
                plan_len = 1 + len(varint.put_u32(len(d))) + clen
            if k in self.st_pos:
                # stripe candidate: per stripe the smaller of O0/O1
                # (O1 on ties), CAT when neither compresses
                stripes = self.st_stripes[k]
                base = self.st_pos[k]
                picks = []
                inner_lens = []
                for j2, sd in enumerate(stripes):
                    l0 = 1 + ss0[base + j2]
                    l1 = 1 + ss1[base + j2]
                    pick, best_len = (1, l1) if l1 <= l0 else (0, l0)
                    if best_len >= len(sd) + 1:
                        pick, best_len = 2, len(sd) + 1
                    picks.append(pick)
                    inner_lens.append(best_len)
                blob_len = (1 + len(varint.put_u32(len(d))) + 1
                            + sum(len(varint.put_u32(x))
                                  for x in inner_lens)
                            + sum(inner_lens))
                if blob_len < plan_len:
                    plan = ("stripe", picks, base, None)
                    plan_len = blob_len
            self.plans.append(plan)
            self.plan_lens.append(plan_len)

    def _need_sets(self, winners):
        need = [set(), set()]
        sneed = [set(), set()]
        for k, i in enumerate(self.big_idx):
            if i not in winners:
                continue
            kind, a, b_, c = self.plans[k]
            if kind == "plain":
                which, j = c
                need[which].add(j)
            elif kind == "stripe":
                picks, base = a, b_
                for j2, pick in enumerate(picks):
                    if pick < 2:
                        sneed[pick].add(base + j2)
        return need, sneed

    def prefetch(self, winners) -> None:
        if not self.big_idx:
            return
        need, sneed = self._need_sets(winners)
        for enc, want in ((self.enc0, need[0]), (self.enc1, need[1]),
                          (self.senc0, sneed[0]), (self.senc1, sneed[1])):
            if want:
                enc.prefetch(sorted(want))

    def assemble(self, winners) -> dict[int, bytes]:
        """Framed payloads for the requested section indices."""
        out = {i: p for i, p in self.out_host.items() if i in winners}
        if not self.big_idx:
            return out
        need, sneed = self._need_sets(winners)
        f0 = self.enc0.fetch(sorted(need[0])) if need[0] else {}
        f1 = self.enc1.fetch(sorted(need[1])) if need[1] else {}
        sf0 = self.senc0.fetch(sorted(sneed[0])) if sneed[0] else {}
        sf1 = self.senc1.fetch(sorted(sneed[1])) if sneed[1] else {}
        for k, i in enumerate(self.big_idx):
            if i not in winners:
                continue
            d = self.datas[i]
            kind, a, b_, c = self.plans[k]
            if kind == "cat":
                out[i] = _frame(X_CAT, len(d), d)
            elif kind == "plain":
                order, pmeta, (which, j) = a, b_, c
                payload = (f0, f1)[which][j]
                out[i] = (bytes([order]) + varint.put_u32(len(d))
                          + pmeta + payload)
            else:
                picks, base = a, b_
                stripes = self.st_stripes[k]
                inners = []
                for j2, sd in enumerate(stripes):
                    pick = picks[j2]
                    if pick == 2:
                        inners.append(bytes([X_CAT | X_NOSZ]) + sd)
                    else:
                        pay = (sf0, sf1)[pick][base + j2]
                        inners.append(
                            bytes([X_32 | X_NOSZ | pick]) + pay)
                out[i] = (bytes([X_STRIPE | X_32 | 1])
                          + varint.put_u32(len(d))
                          + bytes([len(stripes)])
                          + b"".join(varint.put_u32(len(x))
                                     for x in inners)
                          + b"".join(inners))
        return out


def _adaptive_jobs_host(jobs):
    """Host-codec encode of adaptive jobs (sections under MIN_DEVICE).
    A job the codec declines yields None, the reference's NULL-return
    method skip."""
    devtimer.count("adaptive_jobs_host", len(jobs))
    outs = []
    with devtimer.span("driver/adaptive_small"):
        for j in jobs:
            try:
                if j[0] == "seq":
                    outs.append(host.seq_encode(j[1], j[2], j[3], j[4]))
                else:
                    outs.append(host.fqz_compress(j[1], j[2], j[3], j[4],
                                                  j[5]))
            except ValueError:
                outs.append(None)
    return outs


def _adaptive_jobs(jobs, device: torch.device | Mesh):
    """Adaptive jobs of a segment: sections of at least MIN_DEVICE bytes
    encode in one cross-block batch on the device, smaller ones with the
    host codecs.  Declined jobs come back as None."""
    outs = [None] * len(jobs)
    big = [k for k, j in enumerate(jobs) if len(j[1]) >= MIN_DEVICE]
    small = [k for k, j in enumerate(jobs) if len(j[1]) < MIN_DEVICE]
    if small:
        for k, pay in zip(small,
                          _adaptive_jobs_host([jobs[k] for k in small])):
            outs[k] = pay
    if big:
        pays = adaptive_batch.encode_adaptive_batch([jobs[k] for k in big],
                                                    device)
        for k, pay in zip(big, pays):
            outs[k] = pay
    return outs


class _SegmentTask:
    """One wave segment (blocks sharing a method mask) as a staged
    task, so SEQ and QUAL segments share device batches: start()
    launches the rANS candidate walks and lists the adaptive jobs,
    plan() encodes the adaptive jobs, reads sizes, picks winners and
    records trials, prefetch() and finish() copy back and frame the
    winners.  The best method per block wins with the host's ascending
    method tie-break (fqzcomp5.c:2106, strictly smaller).  Each stage
    runs through step(), which adds its host wall to host_s."""

    def __init__(self, learner, arg, blocks, sec, datas, seg, mask, trial,
                 results, device):
        self.learner = learner
        self.arg = arg
        self.blocks = blocks
        self.sec = sec
        self.datas = datas
        self.seg = seg
        self.mask = mask
        self.trial = trial
        self.results = results
        self.device = device
        self.host_s = 0.0

    def step(self, name: str, stage) -> None:
        """stage() under the devtimer span name, its wall added to
        host_s (the -v report's section seconds)."""
        t0 = time.perf_counter()
        with devtimer.span(name):
            stage()
        self.host_s += time.perf_counter() - t0

    def start(self) -> None:
        seg, mask, datas, blocks = (self.seg, self.mask, self.datas,
                                    self.blocks)
        self.rw = None
        self.rep = None
        rans_mask = mask & _RANS_FAMILY
        if rans_mask:
            # the STRIPE candidate runs for every fixed-length block
            fl = [blocks[i].fixed_len for i in seg]
            self.rw = _RansWave([datas[i] for i in seg], fl, self.device)
            self.rep = (rans_mask & -rans_mask).bit_length() - 1
        self.lzp = {}
        if mask & bit(Method.LZP3):
            devtimer.count("candidate_bytes", sum(len(datas[i]) for i in seg))
            with devtimer.span("driver/lzp3"):
                for i in seg:
                    self.lzp[i] = host.rans_compress(host.lzp(datas[i]), 5)

        jobs, jobmeta = [], []

        def add_seq(m, slevel, both):
            strat = (slevel << 4) | (both << 3) | 1
            for i in seg:
                jobs.append(("seq", datas[i], blocks[i].lens, both,
                             slevel))
                jobmeta.append((i, int(m), strat))

        for m, (slevel, both) in _SEQ_PARAMS.items():
            if mask & bit(m):
                add_seq(m, slevel, both)
        if mask & bit(Method.SEQ_CUSTOM):
            add_seq(Method.SEQ_CUSTOM, self.arg.slevel,
                    self.arg.both_strands)
        for m in _FQZ_METHODS:
            if mask & bit(m):
                strat_n = int(m) - int(Method.FQZ0)
                for i in seg:
                    jobs.append(("fqz", datas[i], blocks[i].lens,
                                 blocks[i].flags, blocks[i].seq_buf,
                                 strat_n))
                    jobmeta.append((i, int(m), 1))
        self.jobs = jobs
        self.jobmeta = jobmeta
        devtimer.count("candidate_bytes", sum(len(j[1]) for j in jobs))

    def plan(self) -> None:
        seg, datas = self.seg, self.datas
        # candidates per block: (method, strat, length, payload|None);
        # a None payload marks the rANS candidate (fetched lazily)
        cands = {i: [] for i in seg}
        if self.rw is not None:
            rlens = self.rw.plan()
            for k, i in enumerate(seg):
                cands[i].append((self.rep, 0, rlens[k], None))
        for i, pay in self.lzp.items():
            cands[i].append((int(Method.LZP3), int(Method.LZP3),
                             len(pay), pay))
        declined = {i: [] for i in seg}
        if self.jobs:
            pays = _adaptive_jobs(self.jobs, self.device)
            for (i, m, strat), pay in zip(self.jobmeta, pays):
                if pay is None:
                    declined[i].append(m)  # codec skipped this input
                else:
                    cands[i].append((m, strat, len(pay), pay))
        self.rans_winners = set()
        self.chosen = {}
        for k, i in enumerate(seg):
            cl = sorted(cands[i], key=lambda c: c[0])
            best = min(cl, key=lambda c: c[2])
            self.chosen[i] = best
            if best[3] is None:
                self.rans_winners.add(k)
            if self.trial:
                sizes = {m: (len(datas[i]), ln) for m, _s, ln, _p in cl}
                for m in declined[i]:
                    sizes[m] = (len(datas[i]), (1 << 32) - 1)
                self.learner.record_trial(self.sec, sizes)

    def prefetch(self) -> None:
        if self.rw is not None and self.rans_winners:
            self.rw.prefetch(self.rans_winners)

    def finish(self) -> None:
        rpay = (self.rw.assemble(self.rans_winners)
                if self.rw is not None and self.rans_winners else {})
        for k, i in enumerate(self.seg):
            m, strat, ln, pay = self.chosen[i]
            if pay is None:
                pay = rpay[k]
            self.results[i] = (strat, pay)


def _section_tasks(learner, arg, blocks, sec, datas, results, device):
    """Generator of _SegmentTasks replaying the trial/lock/review state
    machine block by block (learning.py).  The next task's mask is
    computed only after the previous task's plan() recorded its trials,
    so resume strictly after finish()."""
    n = len(blocks)
    bi = 0
    while bi < n:
        mask = learner.methods_for(sec)
        if learner.in_trial(sec):
            take = min(learner.trial_remaining(sec), n - bi)
            for _ in range(take - 1):
                learner.methods_for(sec)
            seg = list(range(bi, bi + take))
            trial = True
        else:
            seg = [bi]
            while (bi + len(seg) < n
                   and not learner.will_reopen(sec)):
                m2 = learner.methods_for(sec)
                if m2 != mask:
                    break
                seg.append(bi + len(seg))
            trial = False
        devtimer.count("trial_blocks" if trial else "locked_blocks",
                       len(seg))
        yield _SegmentTask(learner, arg, blocks, sec, datas, seg, mask,
                           trial, results, device)
        bi = seg[-1] + 1


def encode_wave_blocks(learner: MethodLearner, arg: Options,
                       wave: list[fastq.FastqBatch],
                       device: torch.device | Mesh
                       ) -> list[tuple[bytes, Timings]]:
    """Encode one wave of batches into serialized blocks (framing + CRC
    included).  SEQ and QUAL segments run in lockstep, so both
    sections' candidate walks are in flight together.  Each block's
    Timings: see drivers.Timings."""
    with devtimer.span("driver/wave"):
        devtimer.count("waves", 1)
        qual_blocks = [fq for fq in wave if not fq.is_fasta]
        seqs: list = [None] * len(wave)
        quals: list = [None] * len(qual_blocks)
        gens = [
            _section_tasks(learner, arg, wave, Section.SEQ,
                           [fq.seq_buf for fq in wave], seqs, device),
            _section_tasks(learner, arg, qual_blocks, Section.QUAL,
                           [fq.qual_buf for fq in qual_blocks], quals,
                           device),
        ]
        sec_s = {Section.SEQ: 0.0, Section.QUAL: 0.0}
        pending = [next(g, None) for g in gens]
        while any(p is not None for p in pending):
            act = [p for p in pending if p is not None]
            with _bk.deferred_walks():
                for tk in act:
                    tk.step("driver/start", tk.start)
            for tk in act:
                tk.step("driver/plan", tk.plan)
            with _bk.deferred_walks():
                for tk in act:
                    tk.step("driver/assemble", tk.prefetch)
            for tk in act:
                tk.step("driver/assemble", tk.finish)
                sec_s[tk.sec] += tk.host_s
            pending = [next(g, None) if p is not None else None
                       for g, p in zip(gens, pending)]
        seq_bytes = max(1, sum(len(fq.seq_buf) for fq in wave))
        qual_bytes = max(1, sum(len(fq.qual_buf) for fq in qual_blocks))
        results = []
        qi = 0
        for w, fq in enumerate(wave):
            out = bytearray()
            out += struct.pack("<I", 0)
            out += struct.pack("<I", fq.num_records)
            out += struct.pack("<I", 0)
            nmask = learner.methods_for(Section.NAME)
            devtimer.count("candidate_bytes", len(fq.name_buf)
                           * bin(nmask & _TRIED_BITS).count("1"))
            t0 = time.perf_counter()
            with devtimer.span("driver/names"):
                npay, _, _ = compress_with_methods(
                    learner, arg, fq, nmask, Section.NAME, fq.name_buf)
            name_s = time.perf_counter() - t0
            with devtimer.span("driver/frame"):
                out += npay
                if fq.fixed_len:
                    v = varint.put_u32(fq.fixed_len)
                    out += bytes([len(v)]) + v
                    len_csize = 1 + len(v)
                else:
                    blob = varint.put_array_u32(fq.lens)
                    out += bytes([0]) + struct.pack("<I", len(blob)) + blob
                    len_csize = 5 + len(blob)
                sstrat, spay = seqs[w]
                out += struct.pack("<BII", sstrat, len(fq.seq_buf),
                                   len(spay)) + spay
                if not fq.is_fasta:
                    qstrat, qpay = quals[qi]
                    out += struct.pack("<BII", qstrat, len(fq.qual_buf),
                                       len(qpay)) + qpay
                    qi += 1
                else:
                    out += struct.pack("<BII", 0, 0, 0)
                crc = zlib.crc32(bytes(out[12:])) & 0xFFFFFFFF
                struct.pack_into("<I", out, 8, crc)
                struct.pack_into("<I", out, 0, len(out) - 4)

            bt = Timings()
            bt.update(0, len(fq.name_buf), len(npay), name_s)
            bt.update(3, 4 * fq.num_records, len_csize, 0.0)
            bt.update(1, len(fq.seq_buf), len(spay) + 9,
                      sec_s[Section.SEQ] * len(fq.seq_buf) / seq_bytes)
            if not fq.is_fasta:
                bt.update(2, len(fq.qual_buf), len(qpay) + 9,
                          sec_s[Section.QUAL] * len(fq.qual_buf)
                          / qual_bytes)
            results.append((bytes(out), bt))
        return results


def encode_stream(batches, out_fp: BinaryIO, arg: Options, t: Timings,
                  device: torch.device | Mesh) -> None:
    with devtimer.span("parse/container"):
        container.write_header(out_fp)
    idx = container.FileIndex()
    learner = MethodLearner()
    learner.method_avail = method_avail_for(arg)

    def flush_wave(wave: list[fastq.FastqBatch]):
        if not wave:
            return
        for (blk, bt), fq in zip(
                encode_wave_blocks(learner, arg, wave, device), wave):
            with devtimer.span("driver/write"):
                idx.add(out_fp.tell(), len(fq.seq_buf), fq.num_records)
                out_fp.write(blk)
            t.append_block(bt, arg.verbose)

    nmax, budget = wave_blocks(), wave_budget()
    wave: list[fastq.FastqBatch] = []
    acc = 0
    for fq in batches:
        if fq is None or fq.num_records == 0:
            break
        wave.append(fq)
        acc += len(fq.seq_buf) + len(fq.qual_buf)
        if len(wave) >= nmax or acc >= budget:
            flush_wave(wave)
            wave = []
            acc = 0
    flush_wave(wave)

    with devtimer.span("parse/container"):
        index_offset = out_fp.tell()
        container.write_index(out_fp, idx)
        container.patch_index_offset(out_fp, index_offset)


def _batches(parser, blk_size: int):
    while True:
        with devtimer.span("parse/batch"):
            b = parser.next_batch(blk_size)
            if b is not None:
                devtimer.count("blocks", 1)
                devtimer.count("parse_bytes", len(b.name_buf)
                               + len(b.seq_buf) + len(b.qual_buf))
        if b is None:
            return
        yield b


def encode_file(in_path, out_fp: BinaryIO, arg: Options, t: Timings,
                device: torch.device | Mesh) -> None:
    # the parser, held only by the batch generator, is freed inside the
    # span: its buffers' release is the encode's time
    with devtimer.span("encode"):
        encode_stream(_batches(fastq.Parser(fastq.open_input(in_path)),
                               arg.blk_size), out_fp, arg, t, device)


def encode_paired(in1, in2, out_fp: BinaryIO, arg: Options, t: Timings,
                  device: torch.device | Mesh) -> None:
    with devtimer.span("encode"):
        encode_stream(_batches(fastq.InterleavedParser(
            fastq.open_input(in1), fastq.open_input(in2)), arg.blk_size),
            out_fp, arg, t, device)


# ---------------------------------------------------------------------
# Decode: wave-batched device rANS for plain, PACK'd and STRIPE'd X32
# seq/qual sections; everything else decodes on the host.

def _parse_stripe_job(payload: bytes):
    """Parse a STRIPE section into device-decodable sub-jobs.
    Returns (ulen, [(order01_or_None, body, osize), ...]) where order01
    None marks a CAT stripe (body = raw bytes); returns None for
    anything the device decoder does not take (host path)."""
    if len(payload) < 4 or not (payload[0] & X_STRIPE):
        return None
    ulen, nb = varint.get_u32(payload, 1)
    off = 1 + nb
    if off >= len(payload):
        return None
    N = payload[off]
    off += 1
    if N < 1:
        return None
    clens = []
    for _ in range(N):
        c, nb = varint.get_u32(payload, off)
        off += nb
        clens.append(c)
    ulenN = [ulen // N + (1 if (ulen % N) > i else 0) for i in range(N)]
    subs = []
    for i in range(N):
        sub = payload[off:off + clens[i]]
        off += clens[i]
        if not sub:
            return None
        inner = sub[0]
        if inner == (X_CAT | X_NOSZ):
            subs.append((None, sub[1:], ulenN[i]))
        elif (inner & ~1) == (X_32 | X_NOSZ) and len(sub) > 130:
            subs.append((inner & 1, sub[1:], ulenN[i]))
        else:
            return None  # non-X32/tiny inner: host decodes the section
    return ulen, subs


def _unstripe(parts: list[bytes], ulen: int) -> bytes:
    N = len(parts)
    out = np.empty(ulen, np.uint8)
    for j, p in enumerate(parts):
        out[j::N] = np.frombuffer(p, np.uint8)
    return out.tobytes()


def _parse_device_job(payload: bytes):
    """Parse a section payload the device decoder takes: plain or
    PACK'd X32 rANS.  Returns (order01, body, body_out_size, post) or
    None for the host path; post(packed_bytes) -> section bytes."""
    if len(payload) < 5:
        return None
    order = payload[0]
    if order & ~(X_PACK | X_32 | 1):
        return None
    if not (order & X_32):
        return None
    ulen, nb = varint.get_u32(payload, 1)
    off = 1 + nb
    if order & X_PACK:
        if off >= len(payload):
            return None
        n = payload[off]
        if n == 0 or n > 16:
            return None  # 256-symbol wrap or unpackable: host path
        syms = np.frombuffer(payload[off + 1:off + 1 + n], np.uint8)
        off += 1 + n
        psize, nb = varint.get_u32(payload, off)
        off += nb
        body = payload[off:]
        if len(body) < 130:
            return None
        return (order & 1, body, psize,
                lambda pk, u=ulen, s=syms: unpack_np(pk, u, s))
    body = payload[off:]
    if len(body) < 130:
        return None
    return order & 1, body, ulen, None


def _split_block(raw: bytes, file_version: int):
    """Parse section boundaries of one serialized block (no decode)."""
    off = 8
    if file_version == VERS_V11:
        off += 4
    m = {}
    (u_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    nstrat = raw[off]
    off += 1
    (c_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    m["names"] = (nstrat, u_len, raw[off:off + c_len])
    off += c_len
    lstrat = raw[off]
    off += 1
    if lstrat > 0:
        _, n = varint.get_u32(raw, off)
        off += n
    else:
        (blen,) = struct.unpack_from("<I", raw, off)
        off += 4 + blen
    for key in ("seq", "qual"):
        strat = raw[off]
        off += 1
        (ulen, clen) = struct.unpack_from("<II", raw, off)
        off += 8
        m[key] = (strat, ulen, raw[off:off + clen])
        off += clen
    return m


def decode_file(in_fp: BinaryIO, writer, arg: Options, t: Timings,
                device: torch.device | Mesh, *, tables: str = "lut") -> None:
    """Decode an archive, writing batches through `writer`.  `tables`
    picks the rANS decode walks' table form ("lut" or "boundary", see
    engine_cuda.decode_o0_batch)."""
    with devtimer.span("decode"):
        _decode_file(in_fp, writer, arg, t, device, tables)


def _decode_file(in_fp: BinaryIO, writer, arg: Options, t: Timings,
                 device: torch.device | Mesh, tables: str) -> None:
    with devtimer.span("parse/container"):
        file_version, index_offset = container.read_header(in_fp)

    def flush(wave):
        if not wave:
            return
        with devtimer.span("decode/split"):
            jobs0, jobs1, stripe_parts, stripe_ulen = _split_wave(
                wave, file_version)
        # both orders' walks are launched before either is waited on
        with devtimer.span("prep/dec_tables"):
            fins = [(jobs, dec([j[1] for j in jobs], [j[2] for j in jobs],
                               device, lazy=True, tables=tables))
                    for jobs, dec in ((jobs0, decode_o0_batch),
                                      (jobs1, decode_o1_batch)) if jobs]
        dev_results = {}
        for jobs, fin in fins:
            with devtimer.span("prep/dec_finish"):
                res = fin()
            with devtimer.span("decode/unpack"):
                for j, r in zip(jobs, res):
                    key = j[0]
                    if len(key) == 3:  # stripe sub-stream
                        stripe_parts[key[:2]][key[2]] = r
                    else:
                        dev_results[key] = j[3](r) if j[3] else r
        with devtimer.span("decode/unstripe"):
            for key, parts in stripe_parts.items():
                if all(p is not None for p in parts):
                    dev_results[key] = _unstripe(parts, stripe_ulen[key])

        # residual host decode (names, adaptive and small sections)
        # threads across the wave's blocks; writes drain in order
        def job(i, raw, parent=None):
            with devtimer.span("decode/block", parent):
                pre = {k[1]: v for k, v in dev_results.items() if k[0] == i}
                devtimer.count("host_sections", 3 - len(pre))
                bt = Timings()
                fq = decode_block(raw, file_version, predecoded=pre,
                                  timings=bt)
            return fq, bt

        def write(fq, bt):
            t.append_block(bt, arg.verbose)
            with devtimer.span("decode/write"):
                writer(fq)

        nthread = max(1, arg.nthread)
        with devtimer.span("decode/host_blocks"):
            if nthread == 1 or len(wave) == 1:
                for i, raw in enumerate(wave):
                    write(*job(i, raw))
            else:
                cur = devtimer.current()
                with cf.ThreadPoolExecutor(max_workers=nthread) as pool:
                    futs = [pool.submit(job, i, raw, cur)
                            for i, raw in enumerate(wave)]
                    for f in futs:
                        write(*f.result())

    nmax = wave_blocks()
    raws = container.iter_raw_blocks(in_fp, index_offset)
    wave_raw: list[bytes] = []
    while True:
        with devtimer.span("parse/container"):
            raw = next(raws, None)
        if raw is None:
            break
        wave_raw.append(raw)
        if len(wave_raw) >= nmax:
            flush(wave_raw)
            wave_raw = []
    flush(wave_raw)


def _split_wave(wave: list[bytes], file_version: int):
    """The wave's seq and qual sections the device decodes: (order-0
    jobs, order-1 jobs, stripe parts, stripe lengths); a job is (key,
    body, osize, post), keyed (block, section) or (block, section,
    stripe), and stripe_parts[(block, section)] holds a CAT stripe's
    bytes and None where a job decodes one."""
    jobs0, jobs1 = [], []
    stripe_parts = {}
    stripe_ulen = {}
    for i, raw in enumerate(wave):
        m = _split_block(raw, file_version)
        for sec in ("seq", "qual"):
            strat, ulen, payload = m[sec]
            if strat != 0:
                continue
            st = _parse_stripe_job(payload)
            if st is not None:
                s_ulen, subs = st
                stripe_ulen[(i, sec)] = s_ulen
                parts = [None] * len(subs)
                for j2, (o01, body, osize) in enumerate(subs):
                    if o01 is None:
                        parts[j2] = body  # CAT stripe
                    else:
                        (jobs1 if o01 else jobs0).append(
                            ((i, sec, j2), body, osize, None))
                stripe_parts[(i, sec)] = parts
                continue
            job = _parse_device_job(payload)
            if job is None:
                continue
            o01, body, osize, post = job
            (jobs1 if o01 else jobs0).append(
                ((i, sec), body, osize, post))
    return jobs0, jobs1, stripe_parts, stripe_ulen
