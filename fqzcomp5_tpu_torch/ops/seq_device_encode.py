"""Pass 1 and the event stream of the SEQ codec's device encode.

A port of the JAX package's ``ops/seq_device_encode.py``, the order-k
sequence codec (native/seq.cpp:39-157; reference encode_seq,
fqzcomp5.c:1073-1270) in the three-pass form:

  seq_model    TinyModel<4> per 4^k k-mer context; in both-strands
               mode every base also updates (without output) the
               reverse-complement context
  run_len[3]   AdaptiveModel<256,16> per state: class-run lengths in
               255-chunks
  state_model  TinyModel<2> per state: run-class transitions
  literal      AdaptiveModel<256,16>: raw bytes of 'other' runs

``seq_contexts`` walks the read positions with all records of the block
as one batch of torch ops on the device; ``build_events`` merges run,
transition and base events into one stream in native encode order on
the host.  Passes 2 and 3 run in ``adaptive_batch``; ``encode_payload``
encodes one section through it (the host driver's per-block route).
"""

from __future__ import annotations

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import devtimer

SEED_FWD = 0x007616C7
SEED_REV = 0x2C6B62FF

_LUT = np.full(256, 4, np.int32)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _LUT[_c] = 0x80 + _i

# model-family tags in the merged event stream
FAM_SEQ = 0      # TinyModel<4> per k-mer context
FAM_STATE = 1    # TinyModel<2> per state
FAM_WIDE = 2     # AdaptiveModel<256,16>: run_len[0..2]=0..2, literal=3
MID_LITERAL = 3


def seq_contexts(codes: torch.Tensor, ctx_size: int):
    """Forward/reverse k-mer context walk, records along rows.

    codes: (R, L) int32 base codes (pad with 4).  Returns per byte
    (ctx_fwd before the byte, base, ctx_rev after the byte, reverse
    base: the low two bits of the reverse context before the byte) as
    (R, L) int32 tensors -- garbage on non-base bytes
    (seq_device_encode.seq_contexts of the JAX package)."""
    R, L = codes.shape
    dev = codes.device
    i64 = torch.int64
    mask = (1 << (2 * ctx_size)) - 1
    hi = 2 * ctx_size - 2
    last = torch.full((R,), SEED_FWD & mask, dtype=i64, device=dev)
    last2 = torch.full((R,), (SEED_REV >> (32 - 2 * ctx_size)) & mask,
                       dtype=i64, device=dev)
    outs = [torch.empty((R, L), dtype=torch.int32, device=dev)
            for _ in range(4)]
    for k in range(L):
        code = codes[:, k].to(i64)
        isbase = (code < 4) | (code >= 0x80)
        b = code & 3
        outs[0][:, k] = last
        outs[1][:, k] = b
        outs[3][:, k] = last2 & 3
        last = torch.where(isbase, ((last << 2) + b) & mask, last)
        last2 = torch.where(isbase, (last2 >> 2) + ((3 - b) << hi), last2)
        outs[2][:, k] = last2
    return tuple(outs)


def build_events(seq_buf: bytes, lens, both_strands: int, ctx_size: int,
                 device: torch.device):
    """Merge the full event stream in native encode order, with pass 1
    on `device`.  Returns (fam int8, mid int64, sym int32, upd bool)
    numpy arrays; upd marks the both-strands update-only events."""
    buf = np.frombuffer(seq_buf, np.uint8)
    lens = np.asarray(lens, np.uint32)
    n = len(buf)
    if n == 0:
        return (np.zeros(0, np.int8), np.zeros(0, np.int64),
                np.zeros(0, np.int32), np.zeros(0, bool))
    code = _LUT[buf]
    cls = np.where(code < 4, 0, np.where(code >= 0x80, 1, 2))

    # pass 1 on the device, records along rows (pad code 4 = non-base,
    # contexts hold); in-record cells in row-major order are the
    # stream order
    L = int(lens.max())
    devtimer.count("pass1_cells", len(lens) * L)
    devtimer.count("pass1_symbols", n)
    lens_d = torch.from_numpy(lens.astype(np.int64)).to(device)
    mask = torch.arange(L, device=device)[None, :] < lens_d[:, None]
    codes2d = torch.full((len(lens), L), 4, dtype=torch.int32, device=device)
    codes2d[mask] = torch.from_numpy(code).to(device)
    ctxf_f, b_f, ctxr_f, b2_f = (x[mask].cpu().numpy() for x in
                                 seq_contexts(codes2d, ctx_size))

    # maximal class runs over the FLAT buffer (they cross records)
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
            # the machine starts in kUpper: a zero-length run plus a
            # transition precede a buffer that opens lower/other
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
                # base encode + shadow update interleave per byte
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


def encode_payload(seq_buf: bytes, lens, both_strands: int, ctx_size: int,
                   device) -> bytes:
    """The range-coder payload of one SEQ section, encoded on `device` (a
    torch.device or a Mesh): byte-identical to the native codec's
    (codecs.host.seq_encode), with no cap on its size.  One job through
    adaptive_batch, so the host driver's per-block route and the wave
    engine share one implementation."""
    from fqzcomp5_tpu_torch.ops.adaptive_batch import encode_adaptive_batch

    return encode_adaptive_batch(
        [("seq", seq_buf, lens, both_strands, ctx_size)], device)[0]
