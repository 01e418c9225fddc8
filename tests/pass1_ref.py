"""The numpy merge of pass 1 that the port's device merge
(``fqz_device_encode.build_stream``, ``seq_device_encode.build_events``)
is held against.

The contexts are the port's own (``fqz_ctx_torch.compute_contexts``,
``seq_device_encode.seq_contexts``) on `device`; they come back to the
host and are merged there in numpy, into the (model id, symbol) stream of
the native encoder (native/fqzqual.cpp:698-756, native/seq.cpp:39-157).
Imports no JAX, so the card's tests may use it too.
"""

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import fqz_ctx_torch
from fqzcomp5_tpu_torch.ops.fqz_device_encode import (K_G_HAVE_STAB,
                                                      K_G_MULTI_PARAM,
                                                      MID_DUP, MID_LEN0,
                                                      MID_SEL)
from fqzcomp5_tpu_torch.ops.seq_device_encode import (FAM_SEQ, FAM_STATE,
                                                      FAM_WIDE, MID_LITERAL,
                                                      seq_contexts)

_BASE_LUT = np.zeros(256, np.int64)  # fqzqual.cpp:195-206
for _i, _cs in enumerate((b"Cc", b"Gg", b"TtUu")):
    for _c in _cs:
        _BASE_LUT[_c] = _i + 1

_LUT = np.full(256, 4, np.int32)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _LUT[_c] = 0x80 + _i


def dup_flags(quals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """dup[r] = record r byte-equals record r-1 (fqzqual.cpp:738-745)."""
    nrec = len(lens)
    dup = np.zeros(nrec, bool)
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens
    for r in range(1, nrec):
        if lens[r] == lens[r - 1]:
            a = quals[starts[r - 1]:ends[r - 1]]
            b = quals[starts[r]:ends[r]]
            dup[r] = bool((a == b).all())
    return dup


def _pad_rows(flat: torch.Tensor, lens: torch.Tensor, L: int, fill):
    cols = torch.arange(L, device=flat.device)
    mask = cols[None, :] < lens[:, None]
    plane = torch.full((len(lens), L), fill, dtype=flat.dtype,
                       device=flat.device)
    plane[mask] = flat
    return plane, mask


def build_stream(qual: bytes, lens, sels, P, device, seq=None):
    """(mids int64, syms int32, n_overhead) numpy arrays of one fqz job."""
    qa = np.frombuffer(qual, np.uint8)
    lens = np.asarray(lens, np.uint32)
    sels = np.asarray(sels, np.uint32)
    nrec = len(lens)

    pidx = (P.stab[sels] if (P.gflags & K_G_HAVE_STAB)
            else sels).astype(np.int64)
    multi = bool(P.gflags & K_G_MULTI_PARAM)
    do_sel = P.do_sel.astype(bool)
    do_dedup = P.do_dedup.astype(bool)
    fixed_len = P.fixed_len.astype(bool)
    dup = (dup_flags(qa, lens)
           if do_dedup.any() else np.zeros(nrec, bool))
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens

    L = int(lens.max()) if nrec else 0
    lens_d = torch.from_numpy(lens.astype(np.int64)).to(device)
    quals2d, mask = _pad_rows(torch.from_numpy(qa.copy()).to(device),
                              lens_d, L, int(qa[0]) if len(qa) else 0)
    seqkw = {}
    if seq is not None and P.bbits.any():
        codes = _BASE_LUT[np.frombuffer(seq, np.uint8)]
        boff_r = P.boff[pidx].astype(np.int64)
        nb = np.maximum(lens.astype(np.int64) - boff_r, 0)
        codes_d = torch.from_numpy(codes).to(device)
        src = (torch.from_numpy(starts + boff_r).to(device)[:, None]
               + torch.arange(L, device=device)[None, :])
        inb = (torch.arange(L, device=device)[None, :]
               < torch.from_numpy(nb).to(device)[:, None])
        bases = torch.where(inb, codes_d[src.clamp(max=max(len(codes) - 1,
                                                           0))], 0)
        seq0 = np.zeros(nrec, np.int64)
        for k in range(int(boff_r.max(initial=0))):
            upd = k < boff_r
            bc = codes[np.minimum(starts + k, len(codes) - 1)]
            seq0 = np.where(upd, (seq0 << 2) | bc, seq0)
        seqkw = dict(bases=bases, seq0=torch.from_numpy(seq0).to(device))
    cj, qj = fqz_ctx_torch.compute_contexts(
        quals2d, lens_d, torch.from_numpy(pidx).to(device),
        torch.from_numpy(sels.astype(np.int64)).to(device),
        fqz_ctx_torch.params_to_torch(P, device), **seqkw)
    ctx_f = cj[mask].cpu().numpy()
    qm_f = qj[mask].cpu().numpy()

    prev_p = np.concatenate(([0], pidx[:-1]))
    sel_emit = do_sel[prev_p] | multi
    len_emit = ~fixed_len[pidx]
    if nrec:
        len_emit[0] = True  # st.first_len
    dup_emit = do_dedup[pidx]
    qual_cnt = np.where(dup, 0, lens.astype(np.int64))
    per_rec = (sel_emit + 4 * len_emit + dup_emit).astype(np.int64) \
        + qual_cnt
    offs = np.concatenate(([0], np.cumsum(per_rec)))
    w = int(offs[-1])
    mids = np.empty(w, np.int64)
    syms = np.empty(w, np.int32)

    pos = offs[:-1].copy()
    ridx = np.flatnonzero(sel_emit)
    mids[pos[ridx]] = MID_SEL
    syms[pos[ridx]] = sels[ridx]
    pos += sel_emit
    ridx = np.flatnonzero(len_emit)
    for k in range(4):
        mids[pos[ridx] + k] = MID_LEN0 + k
        syms[pos[ridx] + k] = (lens[ridx].astype(np.int64)
                               >> (8 * k)) & 0xFF
    pos += 4 * len_emit
    ridx = np.flatnonzero(dup_emit)
    mids[pos[ridx]] = MID_DUP
    syms[pos[ridx]] = dup[ridx]
    pos += dup_emit
    keep = np.repeat(~dup, lens)
    tgt = (np.repeat(pos - starts, lens)
           + np.arange(len(qa), dtype=np.int64))[keep]
    mids[tgt] = ctx_f[keep]
    syms[tgt] = qm_f[keep]
    n_qual = int(qual_cnt.sum())
    return mids, syms, w - n_qual


def build_events(seq_buf: bytes, lens, both_strands: int, ctx_size: int,
                 device):
    """(fam int8, mid int64, sym int32, upd bool) numpy arrays of one seq
    job: a Python loop over the buffer's class runs."""
    buf = np.frombuffer(seq_buf, np.uint8)
    lens = np.asarray(lens, np.uint32)
    n = len(buf)
    if n == 0:
        return (np.zeros(0, np.int8), np.zeros(0, np.int64),
                np.zeros(0, np.int32), np.zeros(0, bool))
    code = _LUT[buf]
    cls = np.where(code < 4, 0, np.where(code >= 0x80, 1, 2))

    L = int(lens.max())
    lens_d = torch.from_numpy(lens.astype(np.int64)).to(device)
    mask = torch.arange(L, device=device)[None, :] < lens_d[:, None]
    codes2d = torch.full((len(lens), L), 4, dtype=torch.int32, device=device)
    codes2d[mask] = torch.from_numpy(code).to(device)
    ctxf_f, b_f, ctxr_f, b2_f = (x[mask].cpu().numpy() for x in
                                 seq_contexts(codes2d, ctx_size))

    bounds = np.flatnonzero(np.diff(cls)) + 1
    rstarts = np.concatenate(([0], bounds))
    rends = np.concatenate((bounds, [n]))
    fam_l, mid_l, sym_l, upd_l = [], [], [], []

    def emit(fam, mid, sym, upd=None):
        fam_l.append(np.full(len(mid), fam, np.int8))
        mid_l.append(np.asarray(mid, np.int64))
        sym_l.append(np.asarray(sym, np.int32))
        upd_l.append(np.zeros(len(mid), bool) if upd is None
                     else np.asarray(upd, bool))

    state = 0  # kUpper
    first = True
    for rs, re in zip(rstarts, rends):
        rcls = int(cls[rs])
        if first and rcls != 0:
            emit(FAM_WIDE, [state], [0])
            tsym = (state == 2) if rcls == 1 else (0 if rcls == 0
                                                   else 1)
            emit(FAM_STATE, [state], [int(tsym)])
            state = rcls
        first = False
        run = re - rs
        chunks = [255] * (run // 255) + [run % 255]
        emit(FAM_WIDE, [state] * len(chunks), chunks)
        if rcls < 2:
            if both_strands:
                mid = np.empty(2 * run, np.int64)
                sym = np.empty(2 * run, np.int32)
                upd = np.zeros(2 * run, bool)
                mid[0::2] = ctxf_f[rs:re]
                sym[0::2] = b_f[rs:re]
                mid[1::2] = ctxr_f[rs:re]
                sym[1::2] = b2_f[rs:re]
                upd[1::2] = True
                emit(FAM_SEQ, mid, sym, upd)
            else:
                emit(FAM_SEQ, ctxf_f[rs:re], b_f[rs:re])
        else:
            emit(FAM_WIDE, [MID_LITERAL] * run, buf[rs:re])
        if re < n:
            ncls = int(cls[re])
            tsym = 0 if ncls == 0 else ((state == 2) if ncls == 1
                                        else 1)
            emit(FAM_STATE, [state], [int(tsym)])
            state = ncls
    return (np.concatenate(fam_l), np.concatenate(mid_l),
            np.concatenate(sym_l), np.concatenate(upd_l))
