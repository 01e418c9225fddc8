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
transition and base events into one stream in native encode order
there too, the host working only per class run.  Passes 2 and 3 run in
``adaptive_batch``; ``encode_payload`` encodes one section through it
(the host driver's per-block route).
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
# each byte's class: 0 upper base, 1 lower base, 2 other
_CLS = np.where(_LUT < 4, 0, np.where(_LUT >= 0x80, 1, 2))

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


def _run_events(rcls: np.ndarray, rlen: np.ndarray, both_strands: int):
    """Each class run's events, worked out per run on the host: a run
    (of class rcls, rlen bytes) is its ceil-255 length chunks, its base
    events (two a base in both-strands mode, the second update-only) or
    literals, and the transition to the next run; a buffer that opens
    lower/other opens with a zero-length run and a transition, as the
    machine starts in kUpper.  Returns (chunk_off, body_off, mult, w,
    small): each run's first chunk and first body event, events a byte,
    the stream's length, and the opening and transition events as
    (position, family, model id, symbol) columns."""
    nr = len(rcls)
    mult = np.where((rcls < 2) & bool(both_strands), 2, 1)
    nch = rlen // 255 + 1
    opening = 2 if rcls[0] != 0 else 0
    per = nch + rlen * mult + (np.arange(nr) < nr - 1)
    per[0] += opening
    off = np.concatenate(([0], np.cumsum(per)))
    chunk_off = off[:-1].copy()
    chunk_off[0] += opening
    body_off = chunk_off + nch
    # a transition into class c from state s: 0 into upper, s == other
    # into lower, 1 into other
    state = np.concatenate(([0], rcls))
    ncls = np.concatenate((rcls, [0]))
    tsym = np.where(ncls == 0, 0, np.where(ncls == 1, state == 2, 1))
    tpos = np.concatenate(([1], body_off + rlen * mult))
    keep = np.arange(nr + 1) < nr          # no transition after the last
    keep[0] = bool(opening)
    small = [np.stack([tpos[keep], np.full(int(keep.sum()), FAM_STATE),
                       state[keep], tsym[keep]])]
    if opening:
        small.append(np.array([[0], [FAM_WIDE], [0], [0]]))
    return (chunk_off, body_off, mult, int(off[-1]),
            np.concatenate(small, axis=1).astype(np.int64))


def build_events(seq_buf: bytes, lens, both_strands: int, ctx_size: int,
                 device: torch.device):
    """Merge the full event stream in native encode order, on `device`:
    pass 1's contexts are computed there and the stream written there
    from them.  Returns (fam int8, mid int64, sym int32, upd bool)
    tensors on `device`, upd marking the both-strands update-only
    events, and the number of those.

    The buffer's class runs are found on the device; only their bounds
    come back, and the host works per run."""
    buf = np.frombuffer(seq_buf, np.uint8)
    lens = np.asarray(lens, np.uint32)
    n = len(buf)
    if n == 0:
        return (torch.zeros(0, dtype=torch.int8, device=device),
                torch.zeros(0, dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(0, dtype=torch.bool, device=device), 0)

    # pass 1, records along rows (pad code 4 = non-base, contexts hold)
    L = int(lens.max())
    devtimer.count("pass1_cells", len(lens) * L)
    devtimer.count("pass1_symbols", n)
    with devtimer.span("adaptive/pass1/walk"):
        buf_d = devtimer.put(buf, device)
        code = devtimer.put(_LUT, device)[buf_d.to(torch.int64)]
        lens_d = devtimer.put(lens.astype(np.int64), device)
        mask = torch.arange(L, device=device)[None, :] < lens_d[:, None]
        codes2d = torch.full((len(lens), L), 4, dtype=torch.int32,
                             device=device)
        codes2d[mask] = code
        ctx = seq_contexts(codes2d, ctx_size)

    with devtimer.span("adaptive/pass1/merge"):
        # maximal class runs over the FLAT buffer (they cross records)
        cls = torch.where(code < 4, 0, torch.where(code >= 0x80, 1, 2))
        bounds = devtimer.get(torch.nonzero(cls[1:] != cls[:-1])
                              .squeeze(1) + 1)
        rstart = np.concatenate(([0], bounds))
        rlen = np.diff(np.concatenate((rstart, [n])))
        rcls = _CLS[buf[rstart]]
        chunk_off, body_off, mult, w, small = _run_events(rcls, rlen,
                                                          both_strands)
        n_upd = int(rlen[mult == 2].sum())
        devtimer.count("merge_events", w)
        nch = rlen // 255 + 1
        runs = devtimer.put(np.stack([chunk_off, body_off - rstart * mult,
                                      mult, rlen, rcls, nch,
                                      np.cumsum(nch) - nch]), device)
        fam = torch.empty(w, dtype=torch.int8, device=device)
        mid = torch.empty(w, dtype=torch.int64, device=device)
        sym = torch.empty(w, dtype=torch.int32, device=device)
        upd = torch.zeros(w, dtype=torch.bool, device=device)

        # the run-length chunks: 255 each, the last the rest
        nc = int(nch.sum())
        rid = torch.repeat_interleave(torch.arange(len(rlen), device=device),
                                      runs[5], output_size=nc)
        j = torch.arange(nc, device=device) - runs[6][rid]
        at = runs[0][rid] + j
        fam[at] = FAM_WIDE
        mid[at] = runs[4][rid]
        sym[at] = torch.where(j == runs[5][rid] - 1, runs[3][rid] % 255,
                              255).to(torch.int32)

        # one event a byte (two for a base in both-strands mode) at its
        # run's body offset plus the byte's place in the run
        rid = torch.zeros(n, dtype=torch.int64, device=device)
        rid[1:] = torch.cumsum(cls[1:] != cls[:-1], 0)
        at = runs[1][rid] + torch.arange(n, device=device) * runs[2][rid]
        cell = torch.nonzero(mask.view(-1)).squeeze(1)
        ctxf, b, ctxr, b2 = (x.view(-1)[cell] for x in ctx)
        isbase = cls < 2
        fam[at] = torch.where(isbase, FAM_SEQ, FAM_WIDE).to(torch.int8)
        mid[at] = torch.where(isbase, ctxf.to(torch.int64), MID_LITERAL)
        sym[at] = torch.where(isbase, b, buf_d.to(torch.int32))
        if n_upd:
            sh = at[isbase] + 1
            fam[sh] = FAM_SEQ
            mid[sh] = ctxr[isbase].to(torch.int64)
            sym[sh] = b2[isbase]
            upd[sh] = True

        # the opening and the transitions between runs
        small = devtimer.put(small, device)
        fam[small[0]] = small[1].to(torch.int8)
        mid[small[0]] = small[2]
        sym[small[0]] = small[3].to(torch.int32)
    return fam, mid, sym, upd, n_upd


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
