"""Wrapper of the CUDA range-coder encode walk (``csrc/rc_encode.cu``).

``encode_walk`` takes the plain version (``rc_torch.encode_walk_ref``)
for tensors on the CPU and launches the kernel for tensors on a CUDA
device; there is no other route.  ``encode_walk.launches`` counts kernel
launches.  Under ``FQZ5_DEVTIME`` each call is one ``devtimer`` compute
span (``devtimer.timed``).
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import _build, devtimer, rc_torch
from fqzcomp5_tpu_torch.ops.rans_cuda import _check


@devtimer.timed("rc_encode_walk")
def encode_walk(cf: torch.Tensor, tot: torch.Tensor, off: torch.Tensor,
                n: torch.Tensor, state: torch.Tensor, cap: int):
    """B range coders over contiguous step ranges; see
    rc_torch.encode_walk_ref for the arguments and the (out, totals,
    state) results.  On the card, bytes past totals[b] are undefined and
    an overflow of cap shows as totals[b] > cap (nothing is written past
    the row)."""
    if cf.device.type == "cpu":
        return rc_torch.encode_walk_ref(cf, tot, off, n, state, cap)
    if cf.device.type != "cuda":
        raise ValueError(f"encode_walk: no kernel for {cf.device}")
    dev = cf.device
    N = cf.shape[0]
    B = off.shape[0]
    _check("cf", cf, (torch.int32,), (N,), dev)
    _check("tot", tot, (torch.int32,), (N,), dev)
    _check("off", off, (torch.int64,), (B,), dev)
    _check("n", n, (torch.int32,), (B,), dev)
    _check("state", state, (torch.int32,), (5, B), dev)
    if cap < 1:
        raise ValueError(f"encode_walk: cap {cap} < 1")
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    totals = torch.empty((B,), dtype=torch.int32, device=dev)
    st_out = torch.empty((5, B), dtype=torch.int32, device=dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_rc_encode_walk(
            cf.data_ptr(), tot.data_ptr(), off.data_ptr(), n.data_ptr(),
            state.data_ptr(), B, cap, out.data_ptr(), totals.data_ptr(),
            st_out.data_ptr(), stream)
    _build.check(rc, "rc encode_walk")
    _build.count_launch(encode_walk)
    return out, totals, st_out


encode_walk.launches = 0
