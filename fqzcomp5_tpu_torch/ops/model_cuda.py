"""Wrappers of the CUDA model-evolution kernels (``csrc/fqz_evolve.cu``).

``evolve_128``/``evolve_256`` (AdaptiveModel of 128 or 256 slots) and
``tiny_evolve`` (TinyModel of 2 or 4 symbols) take the plain versions
(``fqz_model_torch.evolve_ref``/``tiny_evolve_ref``) for tensors on the
CPU and launch the kernel for tensors on a CUDA device; there is no
other route.  Each wrapper's ``launches`` counts its kernel launches.
Under ``FQZ5_DEVTIME`` each call is one ``devtimer`` compute span
(``devtimer.timed``).
"""

from __future__ import annotations

import torch

from fqzcomp5_tpu_torch.ops import _build, devtimer, fqz_model_torch
from fqzcomp5_tpu_torch.ops.rans_cuda import _check


def _plane_args(symplane: torch.Tensor, counts: torch.Tensor):
    C, T = symplane.shape
    dev = symplane.device
    _check("symplane", symplane, (torch.uint8,), (C, T), dev)
    _check("counts", counts, (torch.int32,), (C,), dev)
    cf = torch.empty((C, T), dtype=torch.int32, device=dev)
    tot = torch.empty((C, T), dtype=torch.int32, device=dev)
    return C, T, dev, cf, tot


def _evolve(symplane, counts, max_sym, step_inc: int, cap: int, wrapper):
    if symplane.device.type == "cpu":
        return fqz_model_torch.evolve_ref(symplane, counts, max_sym, cap,
                                          step_inc)
    if symplane.device.type != "cuda":
        raise ValueError(f"evolve: no kernel for {symplane.device}")
    C, T, dev, cf, tot = _plane_args(symplane, counts)
    _check("max_sym", max_sym, (torch.int32,), (C,), dev)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_evolve(symplane.data_ptr(), counts.data_ptr(),
                           max_sym.data_ptr(), C, T, cap, step_inc,
                           cf.data_ptr(), tot.data_ptr(), stream)
    _build.check(rc, f"evolve_{cap}")
    _build.count_launch(wrapper)
    return cf, tot


@devtimer.timed("evolve_128")
def evolve_128(symplane: torch.Tensor, counts: torch.Tensor,
               max_sym: torch.Tensor, step_inc: int = 16):
    """AdaptiveModels of up to 128 symbols: symplane (C, T) uint8,
    counts and max_sym (C,) int32 -> (cf, tot) (C, T) int32; see
    fqz_model_torch.evolve_ref."""
    return _evolve(symplane, counts, max_sym, step_inc, 128, evolve_128)


@devtimer.timed("evolve_256")
def evolve_256(symplane: torch.Tensor, counts: torch.Tensor,
               max_sym: torch.Tensor, step_inc: int = 16):
    """evolve_128 for models of up to 256 symbols."""
    return _evolve(symplane, counts, max_sym, step_inc, 256, evolve_256)


@devtimer.timed("tiny_evolve")
def tiny_evolve(symplane: torch.Tensor, counts: torch.Tensor, nsym: int):
    """TinyModels of nsym (2 or 4) symbols: symplane (C, T) uint8,
    counts (C,) int32 -> (cf, tot) (C, T) int32; see
    fqz_model_torch.tiny_evolve_ref."""
    if symplane.device.type == "cpu":
        return fqz_model_torch.tiny_evolve_ref(symplane, counts, nsym)
    if symplane.device.type != "cuda":
        raise ValueError(f"tiny_evolve: no kernel for {symplane.device}")
    if nsym not in (2, 4):
        raise ValueError(f"tiny_evolve: nsym {nsym} not 2 or 4")
    C, T, dev, cf, tot = _plane_args(symplane, counts)
    L = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = L.fqz5_tiny_evolve(symplane.data_ptr(), counts.data_ptr(), C, T,
                                nsym, cf.data_ptr(), tot.data_ptr(), stream)
    _build.check(rc, "tiny_evolve")
    _build.count_launch(tiny_evolve)
    return cf, tot


evolve_128.launches = 0
evolve_256.launches = 0
tiny_evolve.launches = 0
