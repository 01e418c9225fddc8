"""Pass 1 of the fqz-qual encode: every quality byte's model context.

A port of the JAX package's ``ops/fqz_ctx_jax.py``.  The fqz quality
model's context arithmetic (fqz_update_ctx, fqzcomp_qual.c:361-418;
native/fqzqual.cpp update_ctx) is integer work on per-record state, so
``compute_contexts`` walks the read positions with all records of the
block as one batch of torch ops, on whatever device its tensors lie.

The parameter tables come from the native parameter picker
(``fqz5_fqz_prepare``'s blob).  ``FqzParams.parse`` is a copy of the JAX
package's numpy parser, which cannot be imported without importing jax;
``params_to_torch`` moves the tables the walk reads to a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

K_CTX_MASK = (1 << 16) - 1
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class FqzParams:
    """Deserialized fqz5_fqz_dump_ctx parameter blob."""

    nparam: int
    gflags: int
    max_sel: int
    max_sym: int
    stab: np.ndarray          # (256,)
    qshift: np.ndarray        # (P,)
    qmask: np.ndarray
    qloc: np.ndarray
    sloc: np.ndarray
    context: np.ndarray
    do_sel: np.ndarray
    do_dedup: np.ndarray
    fixed_len: np.ndarray
    bbits: np.ndarray         # sequence-conditioning (kGUseSeq)
    bloc: np.ndarray
    boff: np.ndarray
    qmap: np.ndarray          # (P, 256)
    qtab: np.ndarray          # (P, 256)
    ptab: np.ndarray          # (P, 1024) pre-shifted by ploc
    dtab: np.ndarray          # (P, 256) pre-shifted by dloc

    @classmethod
    def parse(cls, blob: np.ndarray) -> "FqzParams":
        w = blob.astype(np.uint32)
        nparam, gflags, max_sel, max_sym = (int(w[0]), int(w[1]),
                                            int(w[2]), int(w[3]))
        off = 4
        stab = w[off:off + 256]
        off += 256
        scalars = {k: np.zeros(nparam, np.uint32) for k in
                   ("qshift", "qmask", "qloc", "sloc", "context",
                    "do_sel", "do_dedup", "fixed_len", "do_qa",
                    "do_r2", "bbits", "bloc", "boff")}
        qmap = np.zeros((nparam, 256), np.uint32)
        qtab = np.zeros((nparam, 256), np.uint32)
        ptab = np.zeros((nparam, 1024), np.uint32)
        dtab = np.zeros((nparam, 256), np.uint32)
        names = list(scalars)
        for j in range(nparam):
            for k in names:
                scalars[k][j] = w[off]
                off += 1
            qmap[j] = w[off:off + 256]
            off += 256
            qtab[j] = w[off:off + 256]
            off += 256
            ptab[j] = w[off:off + 1024]
            off += 1024
            dtab[j] = w[off:off + 256]
            off += 256
        return cls(nparam, gflags, max_sel, max_sym, stab,
                   scalars["qshift"], scalars["qmask"], scalars["qloc"],
                   scalars["sloc"], scalars["context"],
                   scalars["do_sel"], scalars["do_dedup"],
                   scalars["fixed_len"], scalars["bbits"],
                   scalars["bloc"], scalars["boff"],
                   qmap, qtab, ptab, dtab)


_TABLES = ("qmap", "qtab", "ptab", "dtab")
_SCALARS = ("qshift", "qmask", "qloc", "sloc", "context", "bbits", "bloc")


def params_to_torch(P: FqzParams, device: torch.device | str
                    ) -> dict[str, torch.Tensor]:
    """The tables compute_contexts reads, as int64 tensors on `device`:
    qmap/qtab/dtab (P, 256), ptab (P, 1024) and the per-parameter
    scalars (P,) of FqzParams."""
    out = {k: torch.from_numpy(getattr(P, k).astype(np.int64)).to(device)
           for k in _TABLES + _SCALARS}
    return out


def compute_contexts(quals: torch.Tensor, lens: torch.Tensor,
                     pidx: torch.Tensor, sels: torch.Tensor,
                     tabs: dict[str, torch.Tensor],
                     bases: torch.Tensor | None = None,
                     seq0: torch.Tensor | None = None):
    """Per-byte fqz contexts for R records at once (the JAX package's
    fqz_ctx_jax.compute_contexts).

    quals: (R, L) uint8 quality bytes (padded); lens, pidx, sels: (R,)
    record length, parameter index and selector; tabs: params_to_torch.
    Sequence conditioning (kGUseSeq, fqzcomp_qual.c:386-388;
    native/fqzqual.cpp:214-215): bases (R, L) base codes consumed at
    each quality byte, seq0 (R,) the seed of the shift register.
    Returns (ctx (R, L) int64, qm (R, L) uint8); byte 0 of a record
    takes the parameter's initial context, byte k+1 the context built
    after byte k; entries past each record's length are garbage."""
    R, L = quals.shape
    dev = quals.device
    i64 = torch.int64
    p = pidx.to(i64)
    qbase, pbase = p * 256, p * 1024
    qmap, qtab, ptab, dtab = (tabs[k].reshape(-1) for k in _TABLES)
    qshift = tabs["qshift"][p]
    qmask = tabs["qmask"][p]
    qloc = tabs["qloc"][p]
    sterm = sels.to(i64) << tabs["sloc"][p]
    ctx0 = tabs["context"][p]
    lens = lens.to(i64)
    if bases is None:
        bmask = torch.zeros(R, dtype=i64, device=dev)
        bloc = bmask
        seqreg = bmask
    else:
        bmask = (1 << tabs["bbits"][p]) - 1
        bloc = tabs["bloc"][p]
        seqreg = seq0.to(i64)
    qctx = torch.zeros(R, dtype=i64, device=dev)
    delta = torch.zeros(R, dtype=i64, device=dev)
    prevq = torch.zeros(R, dtype=i64, device=dev)
    ctx = torch.empty((R, L), dtype=i64, device=dev)
    qms = torch.empty((R, L), dtype=torch.uint8, device=dev)
    if L:
        ctx[:, 0] = ctx0
    for k in range(L):
        qm = qmap[qbase + quals[:, k].to(i64)]
        qms[:, k] = qm
        if k == L - 1:
            break   # the context after the last byte is never used
        # context for byte k+1
        qctx = ((qctx << qshift) + qtab[qbase + qm]) & M32
        pterm = ptab[pbase + (lens - k).clamp(0, 1023)]
        dterm = dtab[qbase + delta.clamp(max=255)]
        if bases is not None:
            seqreg = ((seqreg << 2) | bases[:, k].to(i64)) & bmask
        ctx[:, k + 1] = (((qctx & qmask) << qloc) + pterm + dterm + sterm
                         + (seqreg << bloc)) & K_CTX_MASK
        delta = delta + (prevq != qm).to(i64)
        prevq = qm
    return ctx, qms
