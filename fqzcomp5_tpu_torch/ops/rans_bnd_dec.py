"""The five boundary-table decode walks of
``fqzcomp5_tpu/ops/rans_pallas_dec.py``, with their signatures and layouts.

``decode_walk`` (v1, one stream per 128-lane row), ``decode_walk4`` (v2),
``decode_walk4v3`` and ``decode_walk4v4`` (four streams per row,
lane-replicated tables and counts) and ``decode_walk4v3_o1`` take torch
tensors in the JAX layouts and return what the JAX functions return, as
int32 tensors.  The three order-0 four-stream versions differ on the TPU
only in how they feed words; v2 reads counter tables at every S, v3
packed tables when S <= 64, v4 packed tables only.  The TPU-only knobs
(``interpret``, ``rows_cap``) have no counterpart.

Each function reduces its layout to the compact one (lane 0 of each
32-lane segment), calls one wrapper of ``rans_cuda_bnd`` (the kernel for
CUDA tensors, the plain version for CPU tensors) and lays the results out
as the JAX function does.  The engine calls the compact wrappers
directly; tests and ``chip_smoke.py`` use these.
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import rans_bnd_torch, rans_cuda_bnd
from fqzcomp5_tpu_torch.ops.rans_bnd_torch import LANES, S_SLOTS
from fqzcomp5_tpu_torch.ops.rans_torch import N, as_i16, u32


def _words(words128: torch.Tensor) -> torch.Tensor:
    """(B, W128, 128) int32 word chunks -> (B, W128*128) int16 rows."""
    B = words128.shape[0]
    return as_i16(words128.reshape(B, -1).to(torch.int64) & 0xFFFF)


def _per_stream(x: torch.Tensor) -> torch.Tensor:
    """(B4, 128) lane-replicated values -> (B,) one per stream."""
    return x[:, ::N].reshape(-1).to(torch.int32).contiguous()


def _tables(cexp: torch.Tensor) -> torch.Tensor:
    """(n, B4, 128) lane-replicated table entries -> (B, n)."""
    n = cexp.shape[0]
    return cexp[:, :, ::N].permute(1, 2, 0).reshape(-1, n).contiguous()


def _syms4(syms: torch.Tensor) -> torch.Tensor:
    """Compact (B, T, 32) uint8 symbols -> (T, B4, 128) int32."""
    B, T, _ = syms.shape
    return (syms.to(torch.int32).view(B // S_SLOTS, S_SLOTS, T, N)
            .permute(2, 0, 1, 3).reshape(T, B // S_SLOTS, LANES))


def decode_walk(words128, tab, f0, R0, treal, T: int, shift: int = 12,
                S: int = 256):
    """v1: words128 (B, W128, 128) int32, tab (B, S) int32 counter
    tables (build_dec_tables), f0 (B, 1) symbol-0 freqs, R0 (B, 128)
    int32 states in lanes 0..31, treal (B,) active step counts.  Returns
    (syms (T, B, 128) int32, Rf (B, 128) int32): lanes 32..127 hold no
    state, so the JAX kernel keeps their R0 and writes, at active steps,
    the symbol their R0 looks up; Rf's lane 32 is the word cursor."""
    B = words128.shape[0]
    f0 = f0.reshape(B).to(torch.int32)
    treal = treal.reshape(B).to(torch.int32)
    syms, Rf, ptrf = rans_cuda_bnd.decode_bnd_o0(
        _words(words128), R0[:, :N].contiguous(), tab.contiguous(), f0,
        treal, T, S, packed=False, shift=shift)
    rest = u32(R0[:, N:])
    E = u32(tab).view(B, 1, S).expand(-1, LANES - N, -1)
    base = (u32(f0) << 14).view(B, 1).expand(-1, LANES - N)
    rsym, _, _ = rans_bnd_torch.select_entry(
        E, base, rest & ((1 << shift) - 1),
        torch.ones_like(base, dtype=torch.bool), False)
    active = (torch.arange(T, device=R0.device).view(T, 1, 1)
              < treal.view(1, B, 1))
    out = torch.cat([syms.to(torch.int32).transpose(0, 1),
                     torch.where(active, rsym.to(torch.int32), 0)], dim=2)
    Rf = torch.cat([Rf, ptrf.view(B, 1), R0[:, N + 1:]], dim=1)
    return out, Rf


def _walk4(words128, cexp, f0exp, R0p, texp, T, shift, S, packed):
    B = words128.shape[0]
    syms, Rf, _ = rans_cuda_bnd.decode_bnd_o0(
        _words(words128), R0p.reshape(B, N).contiguous(), _tables(cexp),
        _per_stream(f0exp), _per_stream(texp), T, S, packed=packed,
        shift=shift)
    return _syms4(syms), Rf.reshape(B // S_SLOTS, LANES)


def decode_walk4(words128, cexp, f0exp, R0p, texp, T: int, shift: int = 12,
                 S: int = 256):
    """v2: words128 (B, W128, 128) int32 (B a multiple of 4), cexp
    (S, B4, 128) lane-replicated counter tables, f0exp/R0p/texp
    (B4, 128) per-lane symbol-0 freqs / states / active step counts.
    Returns (syms (T, B4, 128) int32, Rf (B4, 128) int32)."""
    return _walk4(words128, cexp, f0exp, R0p, texp, T, shift, S, False)


def decode_walk4v3(words128, cexp, f0exp, R0p, texp, T: int,
                   shift: int = 12, S: int = 256):
    """v3 (the FQZ5_DEC_V3 order-0 route): decode_walk4's signature and
    results; tables packed (build_dec_tables_p) when S <= 64."""
    return _walk4(words128, cexp, f0exp, R0p, texp, T, shift, S, S <= 64)


def decode_walk4v4(words128, cexp, f0exp, R0p, texp, T: int,
                   shift: int = 12, S: int = 64):
    """v4: decode_walk4v3 for packed tables only (S <= 64, S % 8 == 0)."""
    if S > 64 or S % 8:
        raise ValueError(f"decode_walk4v4: S {S} must be <= 64 and a "
                         "multiple of 8")
    return _walk4(words128, cexp, f0exp, R0p, texp, T, shift, S, True)


def decode_walk4v3_o1(words128, cexp, R0p, texp, T: int, shift: int,
                      A: int, A1: int, last0: int):
    """The FQZ5_DEC_V3 order-1 route: cexp (A1*(A+1), B4, 128)
    lane-replicated dense tables (build_o1_dense_tables), R0p/texp
    (B4, 128).  Returns (syms (T, B4, 128) int32 dense indices, Rf
    (B4, 128) int32, cur (B4, 128) int32 words consumed, replicated over
    each stream's lanes)."""
    B = words128.shape[0]
    syms, Rf, ptrf = rans_cuda_bnd.decode_dense_o1(
        _words(words128), R0p.reshape(B, N).contiguous(), _tables(cexp),
        _per_stream(texp), T, shift, A, A1, last0)
    cur = ptrf.view(B // S_SLOTS, S_SLOTS, 1).expand(-1, -1, N)
    return (_syms4(syms), Rf.reshape(B // S_SLOTS, LANES),
            cur.reshape(B // S_SLOTS, LANES))
