"""Cross-block batched device encode of the adaptive codecs (SEQ*, FQZ*).

A port of the JAX package's ``ops/adaptive_batch.py``: the three-pass
context-sorted decomposition (docs/DEVICE_ADAPTIVE_CODECS.md) with many
blocks' SEQ and FQZ sections sharing one pass-2 batch per model family
and one pass-3 range-coder walk.

Jobs are namespaced into one event stream (job j, model id m -> key
j * JOB_OFF + m) in four model families, grouped by family and context
with one stable sort on the device, and each family evolved across all
jobs at once:

  T4    TinyModel<4>        seq codec k-mer models     model_cuda.tiny_evolve
  T2    TinyModel<2>        seq codec state models     model_cuda.tiny_evolve
  N128  AdaptiveModel<=128  fqz qual / sel / dup       model_cuda.evolve_128
  W256  AdaptiveModel<256>  fqz length bytes, seq      model_cuda.evolve_256
                            run-length and literal

From pass 1 on, the events stay on the device: each job's stream is
merged there from its contexts (``Prep``), count buckets' planes are
built there and the packed triples scattered into event order
(``fqz_model_torch.DevTriples``).  Pass 3 keeps each job's encode
events (a seq job's both-strands update-only events are dropped) and
walks every job's range coder in chunks of CHUNK_T steps with the state
carried, copying back only the bytes.  Payloads are byte-identical to
the native codecs (native/fqzqual.cpp:663-762, native/seq.cpp:39-157).

A job the fqz codec declines (a quality alphabet of 96 symbols or more)
gives None, decided on the host before any device work.  Nothing here
falls back to the host codecs: a device error propagates.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import (devtimer, fqz_model_torch, model_cuda,
                                    rc_cuda)
from fqzcomp5_tpu_torch.ops.fqz_model_torch import DevTriples
from fqzcomp5_tpu_torch.ops.fqz_device_encode import (MID_LEN0, MID_SEL,
                                                      build_stream,
                                                      prepare_fqz)
from fqzcomp5_tpu_torch.ops.rc_torch import (cap_for, finish_events,
                                             init_state)
from fqzcomp5_tpu_torch.ops.seq_device_encode import (FAM_SEQ, FAM_STATE,
                                                      build_events)
from fqzcomp5_tpu_torch.mesh import Mesh, first_device, split_rows

JOB_OFF = 1 << 32        # > any local model id (4^14 seq ctx, 2^16+6 fqz)
FAM_SHIFT = 61           # pass 2's keys: fam << 61 | job * JOB_OFF + mid
CHUNK_T = 1 << 22        # pass-3 steps per kernel launch

# global model families
F_T4, F_T2, F_N128, F_W256 = 0, 1, 2, 3


def _batch_budget_bytes() -> int:
    """Input bytes of the jobs encoded together: FQZ5_ADAPTIVE_BATCH_MB
    MiB (default 128), read at each call.  Jobs share no state, so the
    split never changes a payload's bytes."""
    return int(os.environ.get("FQZ5_ADAPTIVE_BATCH_MB", "128")) << 20


class Prep(NamedTuple):
    """One job after pass 1: its wire header (b"" but for 'fqz' jobs),
    its event stream as tensors on the batch's first device (fam int8,
    mid int64, sym int32), enc, the bool mask of the events pass 3
    encodes (None: all of them), n_enc, their number, and meta, an fqz
    job's (max_sym + 1, max_sel + 1) or None."""
    hdr: bytes
    fam: torch.Tensor
    mid: torch.Tensor
    sym: torch.Tensor
    enc: torch.Tensor | None
    n_enc: int
    meta: tuple[int, int] | None


def _prep_job(job, device: torch.device) -> Prep | None:
    """Pass 1 of one job on `device`, or None for a job the fqz codec
    declines.  'fqz' jobs carry a native wire header; 'fqz_params' jobs,
    whose parameters and selectors were picked already, carry none."""
    if job[0] in ("fqz", "fqz_params"):
        if job[0] == "fqz":
            _, qual, lens, flags, seq_buf, strat = job
            with devtimer.span("adaptive/pass1/params"):
                hdr, P, sels = prepare_fqz(qual, lens, flags, seq_buf,
                                           strat)
        else:
            _, qual, lens, sels, P, seq_buf = job
            hdr = b""
        if int(P.max_sym) >= 96:
            # the native codec's decline (Models::init,
            # native/fqzqual.cpp): >96-symbol alphabets are outside the
            # wire format's safe envelope
            return None
        la = np.ascontiguousarray(lens, np.uint32)
        mids, syms, _ = build_stream(qual, la, sels, P, device,
                                     seq=seq_buf)
        with devtimer.span("adaptive/pass1/merge"):
            is_w256 = (mids >= MID_LEN0) & (mids < MID_SEL)
            fam = torch.where(is_w256, F_W256, F_N128).to(torch.int8)
        meta = (int(P.max_sym) + 1, int(P.max_sel) + 1)
        return Prep(hdr, fam, mids, syms, None, len(mids), meta)
    _, seq_buf, lens, both, slevel = job
    sfam, mid, sym, upd, n_upd = build_events(seq_buf, lens, both, slevel,
                                              device)
    with devtimer.span("adaptive/pass1/merge"):
        fam = torch.where(sfam == FAM_SEQ, F_T4,
                          torch.where(sfam == FAM_STATE, F_T2,
                                      F_W256)).to(torch.int8)
    return Prep(b"", fam, mid, sym, ~upd if n_upd else None,
                len(mid) - n_upd, None)


def _row_alphabets(uniq: np.ndarray, metas) -> np.ndarray:
    """N128 rows' alphabet sizes: qual models take the job's max_sym+1,
    the selector model max_sel+1, the dup model 2."""
    ujob = (uniq // JOB_OFF).astype(np.int64)
    ulm = uniq % JOB_OFF
    msym = np.array([m[0] if m else 2 for m in metas], np.int32)
    msel = np.array([m[1] if m else 2 for m in metas], np.int32)
    return np.where(ulm < MID_LEN0, msym[ujob],
                    np.where(ulm == MID_SEL, msel[ujob], 2)).astype(np.int32)


def _walk(walk, name: str, nsym: int = 0):
    """A run for fqz_model_torch.evolve_grouped: `walk` on a bucket plane
    (TinyModels of nsym symbols when nsym is given, else AdaptiveModels
    of the rows' alphabets), its events counted as walk_symbols/<name>
    and the plane's width, its steps a lane, as walk_steps/<name>."""
    def run(sp, ct, ms, steps):
        devtimer.count("walk_symbols/" + name, steps)
        devtimer.count("walk_steps/" + name, sp.shape[1])
        return walk(sp, ct, nsym) if nsym else walk(sp, ct, ms)
    return run


def _evolve_families(preps, dev: DevTriples,
                     device: torch.device | Mesh) -> None:
    """Pass 2 for the whole batch: the jobs' events (the `fam`, `mid`,
    `sym` tensors of their Preps, in job order, on `device`'s first
    device) are grouped there by family, job and model id in one sort;
    each family's rows are evolved in count buckets on `device` (a
    device, or a Mesh over which each bucket plane's rows split) and the
    triples scattered to event order in `dev`.  The host reads back only
    the families' bounds, the N128 contexts' keys (for their alphabets)
    and a few numbers a bucket."""
    first = first_device(device)
    with devtimer.span("adaptive/group"):
        key = torch.cat([(p.fam.to(torch.int64) << FAM_SHIFT) + p.mid
                         + j * JOB_OFF for j, p in enumerate(preps)])
        sym = torch.cat([p.sym for p in preps])
        uniq, g = fqz_model_torch.group_resident(key, sym)
        del key, sym
        # family F's rows are a run of the sorted keys; N128 rows take
        # their model's alphabet (those over 128 slots, a wide selector
        # model, the 256-slot walk), W256 rows 256
        C = len(uniq)
        fam0 = torch.arange(4, dtype=torch.int64, device=first) << FAM_SHIFT
        bounds = [*devtimer.get(torch.searchsorted(uniq, fam0)).tolist(), C]
        b128 = slice(bounds[F_N128], bounds[F_N128 + 1])
        alphabet = torch.full((C,), 256, dtype=torch.int32, device=first)
        alphabet[b128] = devtimer.put(_row_alphabets(
            devtimer.get(uniq[b128]) - (F_N128 << FAM_SHIFT),
            [p.meta for p in preps]), first)
        # each row's index into runs below
        which = torch.full((C,), 4, dtype=torch.int32, device=first)
        which[:bounds[F_T2]] = 0
        which[bounds[F_T2]:bounds[F_N128]] = 1
        which[b128] = torch.where(alphabet[b128] > 128, 2, 3)
    devtimer.count("group_events", len(dev.cf))
    e256 = _walk(model_cuda.evolve_256, "evolve_256")
    runs = [_walk(model_cuda.tiny_evolve, "tiny_evolve", 4),
            _walk(model_cuda.tiny_evolve, "tiny_evolve", 2),
            e256, _walk(model_cuda.evolve_128, "evolve_128"), e256]
    fqz_model_torch.evolve_grouped(g, runs, which, alphabet, device, dev)


class _RcRange:
    """Pass 3 of one range of streams on one device: stream b codes
    cf/tot[starts[b] : starts[b] + lens[b]] of this range's slice."""

    def __init__(self, cf, tot, starts, lens):
        self.cf, self.tot = cf, tot
        self.starts, self.lens = starts, lens
        self.state = init_state(len(starts), cf.device)
        self.parts: list[list[bytes]] = [[] for _ in starts]
        self.ff_max = 0
        self.longest = int(lens.max())

    def launch(self, t0: int) -> None:
        """The chunk of steps [t0, t0 + CHUNK_T) of every stream."""
        dev = self.cf.device
        n = np.clip(self.lens - t0, 0, CHUNK_T)
        self.cap = cap_for(int(n.max()), self.ff_max)
        off = devtimer.put(self.starts + np.minimum(t0, self.lens), dev)
        self.out, self.totals, self.state = rc_cuda.encode_walk(
            self.cf, self.tot, off, devtimer.put(n.astype(np.int32), dev),
            self.state, self.cap)
        devtimer.count("walk_symbols/rc_encode_walk", int(n.sum()))
        devtimer.count("walk_steps/rc_encode_walk", int(n.max()))
        devtimer.count("rc_chunks", 1)

    def collect(self) -> None:
        """Copy the launched chunk's bytes back."""
        totals = devtimer.get(self.totals)
        if int(totals.max()) > self.cap:
            raise RuntimeError(f"range coder emitted {int(totals.max())} "
                               f"bytes into room for {self.cap}")
        by = devtimer.get(self.out[:, :max(int(totals.max()), 1)])
        for b, part in enumerate(self.parts):
            part.append(by[b, :totals[b]].tobytes())
        self.ff_max = int(self.state[3].max())

    def finish(self) -> list[bytes]:
        tails = finish_events(self.state)
        return [b"".join(p) + t for p, t in zip(self.parts, tails)]


def rc_walk(cf: torch.Tensor, tot: torch.Tensor, starts: np.ndarray,
            lens: np.ndarray, device=None) -> list[bytes]:
    """Pass 3: the range-coder payload of every stream.  Stream b codes
    cf/tot[starts[b] : starts[b] + lens[b]].  All streams walk together
    in launches of CHUNK_T steps with the coder state carried; each
    launch's bytes are copied back, and the five finish_encode
    shift_lows run on the host.  An empty stream is just those five
    shift_lows from the initial state.

    device (default cf's device) may be a Mesh: the streams split into
    ranges, and each range walks its own slice of cf/tot, the span of
    its streams, on its device with its starts rebased to that slice.
    Every range's chunk is launched before any is copied back."""
    walks = []
    for dev, lo, hi in split_rows(cf.device if device is None else device,
                                  len(starts)):
        st, ln = starts[lo:hi], lens[lo:hi]
        a, b = int(st.min()), int((st + ln).max())
        walks.append(_RcRange(cf[a:b].to(dev), tot[a:b].to(dev), st - a,
                              ln))
    longest = int(lens.max()) if len(lens) else 0
    for t0 in range(0, longest, CHUNK_T):
        live = [w for w in walks if w.longest > t0]
        for w in live:
            w.launch(t0)
        for w in live:
            w.collect()
    return [pay for w in walks for pay in w.finish()]


def encode_adaptive_batch(jobs, device: torch.device | Mesh
                          ) -> list[bytes | None]:
    """Encode many adaptive-codec jobs in batched three-pass runs on
    `device`.  Under a Mesh, pass 1 and the triples stay on its first
    device, and passes 2 and 3 split their rows and streams over it.

    jobs: ('fqz', qual, lens, flags, seq_buf, strat), ('fqz_params',
    qual, lens, sels, P, seq_buf) or ('seq', seq_buf, lens, both,
    slevel) tuples.  Returns each job's complete section payload ('fqz'
    payloads include the native wire header),
    byte-identical to the host codecs, or None for a job the fqz codec
    declines.  Jobs whose summed input exceeds the batch budget
    (_batch_budget_bytes, FQZ5_ADAPTIVE_BATCH_MB) run as several
    independent batches."""
    devtimer.count("adaptive_jobs_device", len(jobs))
    budget = _batch_budget_bytes()
    outs: list = []
    chunk: list = []
    acc = 0
    for j in jobs:
        if chunk and acc + len(j[1]) > budget:
            outs.extend(_encode_chunk(chunk, device))
            chunk, acc = [], 0
        chunk.append(j)
        acc += len(j[1])
    if chunk:
        outs.extend(_encode_chunk(chunk, device))
    return outs


def _encode_chunk(jobs, device: torch.device | Mesh) -> list[bytes | None]:
    first = first_device(device)
    with devtimer.span("adaptive/pass1"):
        preps = [_prep_job(j, first) for j in jobs]
    live = [k for k, p in enumerate(preps) if p is not None]
    outs: list = [None] * len(jobs)
    if not live:
        return outs
    preps = [preps[k] for k in live]
    total = sum(len(p.mid) for p in preps)
    devtimer.count("pass2_events", total)

    with devtimer.span("adaptive/evolve"):
        dev = DevTriples(total, first)
        _evolve_families(preps, dev, device)
    with devtimer.span("adaptive/rc"):
        cf, tot = dev.cf, dev.tot
        if any(p.enc is not None for p in preps):
            keep = torch.cat([torch.ones(len(p.mid), dtype=torch.bool,
                                         device=first)
                              if p.enc is None else p.enc for p in preps])
            cf, tot = cf[keep], tot[keep]
        n_enc = np.array([p.n_enc for p in preps], np.int64)
        starts = np.concatenate(([0], np.cumsum(n_enc)[:-1]))
        payloads = rc_walk(cf, tot, starts, n_enc, device)
    for k, p, pay in zip(live, preps, payloads):
        outs[k] = p.hdr + pay
    return outs
