"""Host preparation and pass 1 of the fqz quality codec's device encode.

A port of the JAX package's ``ops/fqz_device_encode.py``.  The native
parameter picker chooses the model parameters and each record's
selector and writes the wire header (``prepare_fqz``); pass 1 computes
every quality byte's model context on the device
(``fqz_ctx_torch.compute_contexts``); ``build_stream`` merges the
per-record overhead symbols (selector, four length bytes, duplicate
flag; native/fqzqual.cpp:698-756) with the quality symbols into one
(model id, symbol) stream in the native encoder's order, on the device
too: the host works only per record.  Passes 2 and 3 run in
``adaptive_batch``; ``fqz_compress_device`` and ``encode_payload``
encode one section through it (the host driver's per-block route).
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


_BASE_LUT = np.zeros(256, np.uint8)  # fqzqual.cpp:195-206
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


def _dup_rows(quals2d: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """dup[r] = record r byte-equals record r-1 (fqzqual.cpp:738-745), on
    the plane's device: rows of equal length are equal past it too (both
    hold the pad)."""
    dup = torch.zeros(len(lens), dtype=torch.bool, device=lens.device)
    dup[1:] = (lens[1:] == lens[:-1]) & (quals2d[1:] == quals2d[:-1]).all(1)
    return dup


def build_stream(qual: bytes, lens, sels, P: fqz_ctx_torch.FqzParams,
                 device: torch.device, seq: bytes | None = None):
    """Merge overhead + quality symbols into one (model_id, symbol)
    stream in the native encoder's order, on `device`: pass 1's contexts
    are computed there and the stream written there from them.  Returns
    (mids int64, syms int32) tensors on `device` and n_overhead.  seq
    enables the kGUseSeq base-conditioned contexts (bbits/bloc/boff).

    The host works per record (parameters, which overhead events each
    record emits, offsets); the device per symbol."""
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
    ends = np.cumsum(lens.astype(np.int64))
    starts = ends - lens

    # pass 1: per-byte contexts for every record.  The pad is a symbol
    # the block holds, so that a stored quality map (which maps only
    # those) keeps the padded entries' lookups in range; what they
    # compute is masked out.
    L = int(lens.max()) if nrec else 0
    devtimer.count("pass1_cells", nrec * L)
    devtimer.count("pass1_symbols", len(qa))
    with devtimer.span("adaptive/pass1/walk"):
        rec = devtimer.put(np.stack([lens.astype(np.int64), pidx,
                                     sels.astype(np.int64)]), device)
        lens_d, pidx_d, sels_d = rec
        quals2d, mask = _pad_rows(devtimer.put(qa, device), lens_d, L,
                                  int(qa[0]) if len(qa) else 0)
        seqkw = {}
        if seq is not None and P.bbits.any():
            seqkw = _seq_planes(np.frombuffer(seq, np.uint8), starts,
                                P.boff[pidx].astype(np.int64), lens, L,
                                device)
        cj, qj = fqz_ctx_torch.compute_contexts(
            quals2d, lens_d, pidx_d, sels_d,
            fqz_ctx_torch.params_to_torch(P, device), **seqkw)

    with devtimer.span("adaptive/pass1/merge"):
        # per record on the host: event counts -> prefix offsets (the
        # encoder tests do_sel on the PREVIOUS record's pm,
        # fqzqual.cpp:700)
        dup_d = None
        dup = np.zeros(nrec, bool)
        if do_dedup.any():
            dup_d = _dup_rows(quals2d, lens_d)
            dup = devtimer.get(dup_d)
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
        n_qual = int(qual_cnt.sum())
        devtimer.count("merge_events", w)

        # the overhead events, (position, model id, symbol) a column
        pos = offs[:-1].copy()
        ev = []
        ridx = np.flatnonzero(sel_emit)
        ev.append(np.stack([pos[ridx], np.full(len(ridx), MID_SEL),
                            sels[ridx]]))
        pos += sel_emit
        ridx = np.flatnonzero(len_emit)
        for k in range(4):
            ev.append(np.stack([pos[ridx] + k,
                                np.full(len(ridx), MID_LEN0 + k),
                                (lens[ridx].astype(np.int64) >> (8 * k))
                                & 0xFF]))
        pos += 4 * len_emit
        ridx = np.flatnonzero(dup_emit)
        ev.append(np.stack([pos[ridx], np.full(len(ridx), MID_DUP),
                            dup[ridx]]))
        pos += dup_emit
        over = devtimer.put(np.concatenate(ev, axis=1).astype(np.int64),
                            device)
        mids = torch.empty(w, dtype=torch.int64, device=device)
        syms = torch.empty(w, dtype=torch.int32, device=device)
        mids[over[0]] = over[1]
        syms[over[0]] = over[2].to(torch.int32)
        # quality bytes: each kept record's bytes land as one run at its
        # pos, in the plane's row-major order
        if n_qual:
            keep = mask if dup_d is None else mask & ~dup_d[:, None]
            cell = torch.nonzero(keep.view(-1)).squeeze(1)
            row = torch.div(cell, L, rounding_mode="floor")
            qpos = devtimer.put(pos, device)
            tgt = qpos[row] + (cell - row * L)
            mids[tgt] = cj.view(-1)[cell]
            syms[tgt] = qj.view(-1)[cell].to(torch.int32)
    return mids, syms, w - n_qual


def _seq_planes(seqa: np.ndarray, starts: np.ndarray, boff_r: np.ndarray,
                lens: np.ndarray, L: int, device: torch.device) -> dict:
    """compute_contexts' sequence-conditioning arguments: bases[r, k] =
    code of seq[start_r + boff_r + k] while k < len_r - boff_r, else 0,
    looked up on `device` from the uploaded bytes; seq0, each record's
    shift register seeded from its first boff_r bases."""
    nrec = len(lens)
    last = max(len(seqa) - 1, 0)
    nb = np.maximum(lens.astype(np.int64) - boff_r, 0)
    per = devtimer.put(np.stack([starts + boff_r, nb]), device)
    cols = torch.arange(L, device=device)
    src = (per[0][:, None] + cols[None, :]).clamp(max=last)
    lut = devtimer.put(_BASE_LUT, device)
    bases = torch.where(cols[None, :] < per[1][:, None],
                        lut[devtimer.put(seqa, device)[src].to(torch.int64)],
                        0)
    # native seeds from seq[off+b] for ALL b < boff, even when the
    # record is shorter than boff (it reads into the next record's
    # bases in the concatenated buffer) -- native/fqzqual.cpp:727.
    # Mirror that exactly; clamp only at the end of the whole buffer
    # (the one case native leaves undefined).
    seq0 = np.zeros(nrec, np.int64)
    for k in range(int(boff_r.max(initial=0))):
        bc = _BASE_LUT[seqa[np.minimum(starts + k, last)]].astype(np.int64)
        seq0 = np.where(k < boff_r, (seq0 << 2) | bc, seq0)
    return dict(bases=bases, seq0=devtimer.put(seq0, device))


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
