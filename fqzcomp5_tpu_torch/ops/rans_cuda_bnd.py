"""Wrappers of the CUDA boundary-table decode walks
(``csrc/rans_decode_bnd.cu``).

``decode_bnd_o0`` and ``decode_dense_o1`` take the plain versions
(``rans_bnd_torch.decode_bnd_o0_ref``/``decode_dense_o1_ref``) for
tensors on the CPU and launch their kernels for tensors on a CUDA
device; there is no other route.  Each wrapper's ``launches`` attribute
counts its kernel launches.  Under ``FQZ5_DEVTIME`` each call is one
``devtimer`` compute span (``devtimer.timed``).
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import _build, devtimer, rans_bnd_torch
from fqzcomp5_tpu_torch.ops.rans_cuda import _check
from fqzcomp5_tpu_torch.ops.rans_torch import TF_SHIFT


def _common(words, R0, t_real, T, shift):
    B, W = words.shape
    dev = words.device
    _check("words", words, (torch.int16,), (B, W), dev)
    if W < 1:
        raise ValueError("decode: the word row needs at least one column")
    _check("R0", R0, (torch.int32,), (B, 32), dev)
    _check("t_real", t_real, (torch.int32,), (B,), dev)
    if not 1 <= shift <= 12:
        raise ValueError(f"decode: shift {shift} not in 1..12")
    syms = torch.empty((B, T, 32), dtype=torch.uint8, device=dev)
    Rf = torch.empty((B, 32), dtype=torch.int32, device=dev)
    ptrf = torch.empty((B,), dtype=torch.int32, device=dev)
    return B, W, dev, syms, Rf, ptrf


@devtimer.timed("decode_bnd_o0")
def decode_bnd_o0(words: torch.Tensor, R0: torch.Tensor, tab: torch.Tensor,
                  f0: torch.Tensor, t_real: torch.Tensor, T: int, S: int, *,
                  packed: bool, shift: int = TF_SHIFT):
    """Order-0 boundary-table decode walk; see
    rans_bnd_torch.decode_bnd_o0_ref for the arguments and the (syms,
    Rf, ptrf) results.  The kernel walks a per-slot table it builds from
    each stream's entries (rans_bnd_torch.bnd_o0_slot_table) and equals
    the plain walk on any table: boundaries in any order, rows summing
    below tot, any F fields."""
    if words.device.type == "cpu":
        return rans_bnd_torch.decode_bnd_o0_ref(
            words, R0, tab, f0, t_real, T, S, packed=packed, shift=shift)
    if words.device.type != "cuda":
        raise ValueError(f"decode_bnd_o0: no kernel for {words.device}")
    B, W, dev, syms, Rf, ptrf = _common(words, R0, t_real, T, shift)
    _check("tab", tab, (torch.int32,), (B, S), dev)
    _check("f0", f0, (torch.int32,), (B,), dev)
    if not 1 <= S <= (64 if packed else 256):
        raise ValueError(f"decode_bnd_o0: S {S} out of range "
                         f"({'packed' if packed else 'counter'} tables)")
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rans_decode_bnd_o0(
            words.data_ptr(), W, R0.data_ptr(), tab.data_ptr(),
            f0.data_ptr(), t_real.data_ptr(), B, T, S, int(packed), shift,
            syms.data_ptr(), Rf.data_ptr(), ptrf.data_ptr(), stream)
    _build.check(rc, "decode_bnd_o0")
    _build.count_launch(decode_bnd_o0)
    return syms, Rf, ptrf


@devtimer.timed("decode_dense_o1")
def decode_dense_o1(words: torch.Tensor, R0: torch.Tensor, tab: torch.Tensor,
                    t_real: torch.Tensor, T: int, shift: int, A: int,
                    A1: int, last0: int):
    """Order-1 dense-table decode walk; see
    rans_bnd_torch.decode_dense_o1_ref for the arguments and the (syms,
    Rf, ptrf) results.  On the card A is at most 255; a stream's compact
    tables (rans_bnd_torch.dense_compact_tables) sit in the block's shared
    memory where they fit, else in a scratch allocated here.  The kernel
    stays in bounds for any table.  It equals the plain walk on every
    table build_o1_dense_tables makes (packed entry c tagged c mod 64):
    in the packed form whatever order the boundaries are in, in the
    counter form where they rise along each row."""
    if words.device.type == "cpu":
        return rans_bnd_torch.decode_dense_o1_ref(
            words, R0, tab, t_real, T, shift, A, A1, last0)
    if words.device.type != "cuda":
        raise ValueError(f"decode_dense_o1: no kernel for {words.device}")
    B, W, dev, syms, Rf, ptrf = _common(words, R0, t_real, T, shift)
    _check("tab", tab, (torch.int32,), (B, A1 * (A + 1)), dev)
    if not 1 <= A <= 255 or A1 not in (A, A + 1) or not 0 <= last0 < A1:
        raise ValueError(f"decode_dense_o1: bad alphabet A={A} A1={A1} "
                         f"last0={last0}")
    stride, scratch = 0, None
    if rans_bnd_torch.dense_route(A, shift) == "global":
        stride = -(-rans_bnd_torch.dense_table_bytes(A, shift) // 16) * 16
        scratch = torch.empty((B, stride), dtype=torch.uint8, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rans_decode_dense_o1(
            words.data_ptr(), W, R0.data_ptr(), tab.data_ptr(), A, A1,
            last0, t_real.data_ptr(), B, T, shift, syms.data_ptr(),
            Rf.data_ptr(), ptrf.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stride, stream)
    _build.check(rc, "decode_dense_o1")
    _build.count_launch(decode_dense_o1)
    return syms, Rf, ptrf


decode_bnd_o0.launches = 0
decode_dense_o1.launches = 0
