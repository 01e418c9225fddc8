"""Host preparation and pass 1 of the fqz quality codec's device encode.

A port of the JAX package's ``ops/fqz_device_encode.py``.  The native
parameter picker chooses the model parameters and each record's
selector and writes the wire header (``prepare_fqz``); pass 1 computes
every quality byte's model context on the device
(``fqz_ctx_torch.compute_contexts``); ``build_stream`` merges the
per-record overhead symbols (selector, four length bytes, duplicate
flag; native/fqzqual.cpp:698-756) with the quality symbols into one
(model id, symbol) stream in the native encoder's order.  Passes 2 and
3 run in ``adaptive_batch``; ``fqz_compress_device`` and
``encode_payload`` encode one section through it (the host driver's
per-block route).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import devtimer, fqz_ctx_torch

K_G_MULTI_PARAM = 1   # native/fqzqual.cpp:29
K_G_HAVE_STAB = 2

# pseudo model ids above the 16-bit qual context space
MID_LEN0 = 1 << 16
MID_SEL = MID_LEN0 + 4
MID_DUP = MID_SEL + 1


def _dup_flags(quals: np.ndarray, lens: np.ndarray) -> np.ndarray:
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


_BASE_LUT = np.zeros(256, np.int64)  # fqzqual.cpp:195-206
for _i, _cs in enumerate((b"Cc", b"Gg", b"TtUu")):
    for _c in _cs:
        _BASE_LUT[_c] = _i + 1


def _pad_rows(flat: torch.Tensor, lens: torch.Tensor, L: int, fill):
    """Ragged records of a flat buffer -> (R, L) plane, `fill` past each
    record's length.  Returns (plane, in-record mask)."""
    cols = torch.arange(L, device=flat.device)
    mask = cols[None, :] < lens[:, None]
    plane = torch.full((len(lens), L), fill, dtype=flat.dtype,
                       device=flat.device)
    plane[mask] = flat
    return plane, mask


def build_stream(qual: bytes, lens, sels, P: fqz_ctx_torch.FqzParams,
                 device: torch.device, seq: bytes | None = None):
    """Merge overhead + quality symbols into one (model_id, symbol)
    stream in the native encoder's order, with pass 1 on `device`.
    Returns (mids int64, syms int32, n_overhead) numpy arrays.  seq
    enables the kGUseSeq base-conditioned contexts (bbits/bloc/boff)."""
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
    dup = (_dup_flags(qa, lens)
           if do_dedup.any() else np.zeros(nrec, bool))
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens

    # pass 1 on the device: per-byte contexts for every record.  The
    # pad is a symbol the block holds, so that a stored quality map
    # (which maps only those) keeps the padded entries' lookups in
    # range; what they compute is masked out.
    L = int(lens.max()) if nrec else 0
    devtimer.count("pass1_cells", nrec * L)
    devtimer.count("pass1_symbols", len(qa))
    lens_d = torch.from_numpy(lens.astype(np.int64)).to(device)
    quals2d, mask = _pad_rows(torch.from_numpy(qa.copy()).to(device),
                              lens_d, L, int(qa[0]) if len(qa) else 0)
    seqkw = {}
    if seq is not None and P.bbits.any():
        codes = _BASE_LUT[np.frombuffer(seq, np.uint8)]
        boff_r = P.boff[pidx].astype(np.int64)
        # bases[r, k] = code of seq[start_r + boff_r + k] while
        # k < len_r - boff_r, else 0
        nb = np.maximum(lens.astype(np.int64) - boff_r, 0)
        codes_d = torch.from_numpy(codes).to(device)
        src = (torch.from_numpy(starts + boff_r).to(device)[:, None]
               + torch.arange(L, device=device)[None, :])
        inb = (torch.arange(L, device=device)[None, :]
               < torch.from_numpy(nb).to(device)[:, None])
        bases = torch.where(inb, codes_d[src.clamp(max=max(len(codes) - 1,
                                                           0))], 0)
        # native seeds from seq[off+b] for ALL b < boff, even when the
        # record is shorter than boff (it reads into the next record's
        # bases in the concatenated buffer) -- native/fqzqual.cpp:727.
        # Mirror that exactly; clamp only at the end of the whole
        # buffer (the one case native leaves undefined).
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
    # in-record entries in row-major order are the stream order
    ctx_f = cj[mask].cpu().numpy()
    qm_f = qj[mask].cpu().numpy()

    # vectorised merge: per-record event counts -> prefix offsets ->
    # scatter each event class into its slots (the encoder tests
    # do_sel on the PREVIOUS record's pm, fqzqual.cpp:700)
    prev_p = np.concatenate(([0], pidx[:-1]))
    sel_emit = do_sel[prev_p] | multi
    len_emit = ~fixed_len[pidx]
    if nrec:
        len_emit[0] = True  # st.first_len
    devtimer.count("len_events", 4 * int(len_emit.sum()))
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
    # quality bytes: each kept record's bytes land as one run at its pos
    keep = np.repeat(~dup, lens)
    tgt = (np.repeat(pos - starts, lens)
           + np.arange(len(qa), dtype=np.int64))[keep]
    mids[tgt] = ctx_f[keep]
    syms[tgt] = qm_f[keep]
    n_qual = int(qual_cnt.sum())
    return mids, syms, w - n_qual


def prepare_fqz(qual: bytes, lens, flags, seq_buf: bytes | None,
                strat: int):
    """Host half of the fqz device encode: parameter picking, selector
    assignment and wire header via fqz5_fqz_prepare.  Returns
    (header_bytes, FqzParams, sels)."""
    from fqzcomp5_tpu_torch.codecs import native

    L = native.lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    qa = np.frombuffer(qual, np.uint8)
    la = np.ascontiguousarray(lens, np.uint32)
    fl = np.array(flags, np.uint32)  # mutated by stats; pass a copy
    nrec = len(la)
    hdr = np.zeros(4096, np.uint8)
    hlen = np.zeros(1, np.uint32)
    par = np.zeros(4 + 256 + 256 * (13 + 256 + 256 + 1024 + 256),
                   np.uint32)
    sels = np.zeros(max(nrec, 1), np.uint32)
    if seq_buf is None:
        seqp = None
    else:
        sa = np.frombuffer(seq_buf, np.uint8)
        seqp = sa.ctypes.data_as(u8p)
    rc = L.fqz5_fqz_prepare(
        qa.ctypes.data_as(u8p), len(qa), la.ctypes.data_as(u32p),
        fl.ctypes.data_as(u32p), nrec, strat, seqp,
        hdr.ctypes.data_as(u8p), len(hdr), hlen.ctypes.data_as(u32p),
        par.ctypes.data_as(u32p), len(par), sels.ctypes.data_as(u32p))
    if rc < 0:
        raise ValueError("fqz_prepare failed")
    P = fqz_ctx_torch.FqzParams.parse(par[:rc])
    return hdr[:int(hlen[0])].tobytes(), P, sels[:nrec]


def encode_payload(qual: bytes, lens, sels, P: fqz_ctx_torch.FqzParams,
                   device, seq: bytes | None = None) -> bytes | None:
    """The range-coder payload of one fqz section (everything after the
    native wire header) for the parameters P and selectors sels that
    prepare_fqz picked, encoded on `device` (a torch.device or a Mesh);
    None where the codec declines P (a quality alphabet of 96 symbols or
    more).  One job through adaptive_batch."""
    from fqzcomp5_tpu_torch.ops.adaptive_batch import encode_adaptive_batch

    return encode_adaptive_batch(
        [("fqz_params", qual, lens, sels, P, seq)], device)[0]


def fqz_compress_device(qual: bytes, lens, flags, seq_buf: bytes | None,
                        strat: int, device) -> bytes | None:
    """codecs.host.fqz_compress with the range-coder payload encoded on
    `device` (a torch.device or a Mesh): the native wire header and the
    payload, byte-identical; None where the codec declines the block
    (a quality alphabet of 96 symbols or more).  One job through
    adaptive_batch."""
    from fqzcomp5_tpu_torch.ops.adaptive_batch import encode_adaptive_batch

    return encode_adaptive_batch(
        [("fqz", qual, lens, flags, seq_buf, strat)], device)[0]
