"""Wrapper of the CUDA rANS encode walk (``csrc/rans_encode.cu``).

``encode_walk`` takes the plain version (``rans_torch.encode_walk_ref``)
for tensors on the CPU and launches the kernel for tensors on a CUDA
device; there is no other route.  ``encode_walk.launches`` counts kernel
launches.  Under ``FQZ5_DEVTIME`` each call is one ``devtimer`` compute
span (``devtimer.timed``).
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import _build, devtimer, rans_torch


def _check(name: str, t: torch.Tensor, dtypes, shape, device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


@devtimer.timed("encode_walk")
def encode_walk(idx: torch.Tensor, tab: torch.Tensor, shift: int,
                R0: torch.Tensor | None = None,
                nsym: torch.Tensor | None = None):
    """Reversed 32-lane encode walk; see rans_torch.encode_walk_ref for
    the arguments and the (Rf, words, nwords) results."""
    if idx.device.type == "cpu":
        return rans_torch.encode_walk_ref(idx, tab, shift, R0, nsym)
    if idx.device.type != "cuda":
        raise ValueError(f"encode_walk: no kernel for {idx.device}")
    B, T, n = idx.shape
    dev = idx.device
    _check("idx", idx, (torch.uint8, torch.int32), (B, T, 32), dev)
    _check("tab", tab, (torch.int32,), (B, tab.shape[1]), dev)
    if (idx.dtype == torch.uint8) != (nsym is not None):
        raise ValueError("encode_walk: uint8 planes need nsym, int32 "
                         "planes carry their sentinels")
    if nsym is not None:
        _check("nsym", nsym, (torch.int32,), (B,), dev)
    if R0 is not None:
        _check("R0", R0, (torch.int32,), (B, 32), dev)
    if shift not in (10, 12):
        raise ValueError(f"encode_walk: shift {shift} not 10 or 12")
    if idx.data_ptr() % 16:
        idx = idx.clone()  # the kernel copies plane rows 16 bytes at a time
    Rf = torch.empty((B, 32), dtype=torch.int32, device=dev)
    words = torch.empty((B, T * 32), dtype=torch.int16, device=dev)
    nwords = torch.empty((B,), dtype=torch.int32, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rans_encode_walk(
            idx.data_ptr(), idx.element_size(),
            nsym.data_ptr() if nsym is not None else None,
            tab.data_ptr(), tab.shape[1], tab.shape[1] - 1,
            R0.data_ptr() if R0 is not None else None,
            B, T, shift, Rf.data_ptr(), words.data_ptr(),
            nwords.data_ptr(), stream)
    _build.check(rc, "encode_walk")
    _build.count_launch(encode_walk)
    return Rf, words, nwords


encode_walk.launches = 0
