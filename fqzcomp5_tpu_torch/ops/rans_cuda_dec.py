"""Wrappers of the CUDA rANS decode walks (``csrc/rans_decode.cu``).

``decode_o0`` and ``decode_o1`` take the plain versions
(``rans_torch.decode_o0_ref``/``decode_o1_ref``) for tensors on the CPU
and launch their kernels for tensors on a CUDA device; there is no other
route.  Each wrapper's ``launches`` attribute counts its kernel
launches.  Under ``FQZ5_DEVTIME`` each call is one ``devtimer`` compute
span (``devtimer.timed``).
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import _build, devtimer, rans_torch
from fqzcomp5_tpu_torch.ops.rans_cuda import _check


def _check_common(words, R0, s3, t_real, s3_width):
    B, W = words.shape
    dev = words.device
    _check("words", words, (torch.int16,), (B, W), dev)
    if W < 1:
        raise ValueError("decode: the word row needs at least one column")
    _check("R0", R0, (torch.int32,), (B, 32), dev)
    _check("s3", s3, (torch.int32,), (B, s3_width), dev)
    _check("t_real", t_real, (torch.int32,), (B,), dev)
    return B, W, dev


@devtimer.timed("decode_o0")
def decode_o0(words: torch.Tensor, R0: torch.Tensor, s3: torch.Tensor,
              t_real: torch.Tensor, T: int):
    """Order-0 decode walk at shift 12; see rans_torch.decode_o0_ref
    for the arguments and the (syms, Rf) results."""
    if words.device.type == "cpu":
        return rans_torch.decode_o0_ref(words, R0, s3, t_real, T)
    if words.device.type != "cuda":
        raise ValueError(f"decode_o0: no kernel for {words.device}")
    B, W, dev = _check_common(words, R0, s3, t_real,
                              1 << rans_torch.TF_SHIFT)
    if s3.data_ptr() % 16:
        s3 = s3.clone()  # the kernel reads s3 rows 16 bytes at a time
    syms = torch.empty((B, T, 32), dtype=torch.uint8, device=dev)
    Rf = torch.empty((B, 32), dtype=torch.int32, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rans_decode_o0(
            words.data_ptr(), W, R0.data_ptr(), s3.data_ptr(),
            t_real.data_ptr(), B, T, syms.data_ptr(), Rf.data_ptr(),
            stream)
    _build.check(rc, "decode_o0")
    _build.count_launch(decode_o0)
    return syms, Rf


@devtimer.timed("decode_o1")
def decode_o1(words: torch.Tensor, R0: torch.Tensor, s3: torch.Tensor,
              t_real: torch.Tensor, T: int, shift: int):
    """Order-1 decode walk; see rans_torch.decode_o1_ref for the
    arguments and the (syms, Rf, ptrf) results."""
    if words.device.type == "cpu":
        return rans_torch.decode_o1_ref(words, R0, s3, t_real, T, shift)
    if words.device.type != "cuda":
        raise ValueError(f"decode_o1: no kernel for {words.device}")
    if shift not in (10, 12):
        raise ValueError(f"decode_o1: shift {shift} not 10 or 12")
    B, W, dev = _check_common(words, R0, s3, t_real, 256 << shift)
    if s3.data_ptr() % 16:
        s3 = s3.clone()  # the kernel reads s3 rows 16 bytes at a time
    syms = torch.empty((B, T, 32), dtype=torch.uint8, device=dev)
    Rf = torch.empty((B, 32), dtype=torch.int32, device=dev)
    ptrf = torch.empty((B,), dtype=torch.int32, device=dev)
    # tables of the streams too wide for shared memory: at most 255
    # slot-table rows and 255 x 256 packed words a stream
    stride = (256 << shift) + 4 * 256 * 256
    scratch = torch.empty((B, stride), dtype=torch.uint8, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rans_decode_o1(
            words.data_ptr(), W, R0.data_ptr(), s3.data_ptr(), shift,
            t_real.data_ptr(), B, T, syms.data_ptr(), Rf.data_ptr(),
            ptrf.data_ptr(), scratch.data_ptr(), stride, stream)
    _build.check(rc, "decode_o1")
    _build.count_launch(decode_o1)
    return syms, Rf, ptrf


decode_o0.launches = 0
decode_o1.launches = 0
