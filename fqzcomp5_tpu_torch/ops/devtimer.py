"""Optional host<->device link vs device-compute accounting
(``FQZ5_DEVTIME``).

The port's counterpart of the JAX package's ``ops/devtimer.py``, with
the same counters.  With FQZ5_DEVTIME=1 the wave engine routes its bulk
transfers and its walks through the helpers here, so that a run can
report the seconds and bytes spent on the link apart from the seconds
the card spends walking:

- ``put(arr, device)``: numpy array -> tensor on device (an upload);
- ``get(tensor)``: tensor -> numpy array on the host (a download);
- ``compute(thunk, device)``: the launches thunk makes on device;
- ``timed``: the decorator that puts each call of a kernel wrapper
  (``rans_cuda``, ``rans_cuda_dec``, ``rans_cuda_bnd``, ``model_cuda``,
  ``rc_cuda``) through ``compute``, so that only the wrappers decide
  what counts as device computation.

Disabled (the default), each helper is a plain call-through: no event,
no synchronisation, no extra copy.  Enabled on a CUDA device, each
transfer and each group of launches is bracketed by a pair of
``torch.cuda.Event(enable_timing=True)`` on the device's current
stream; the pairs are read at ``snapshot()``, not inline, so the walks
keep their asynchrony.  A download's pair starts after the work queued
before it, so it times the copy alone.  On the CPU device the same
counters come from ``time.perf_counter``.  Spans of threads that share
a stream overlap: one thread's event pair also encloses the launches
other threads queued between its two events, so ``compute_s`` then
over-counts (the per-block route's workers all use the current stream).

``link_bytes`` counts the bytes moved in both directions.  ``enabled``
is read from the environment once, at import; a process may set it.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

enabled = os.environ.get("FQZ5_DEVTIME", "0") not in ("", "0")

link_s = 0.0        # seconds spent in host<->device transfers
link_bytes = 0      # bytes moved over the link (both directions)
compute_s = 0.0     # seconds of device computation
compute_calls = 0

_lock = threading.Lock()
_pending: list = []   # (counter, start event, end event) not yet read
_DRAIN_AT = 1024      # fold finished pairs in once this many are pending


def reset() -> None:
    global link_s, link_bytes, compute_s, compute_calls
    with _lock:
        _pending.clear()
        link_s = 0.0
        link_bytes = 0
        compute_s = 0.0
        compute_calls = 0


def _fold(finished_only: bool) -> None:
    """Add the pending event pairs' times to their counters (the caller
    holds _lock); finished_only skips the pairs still in flight."""
    global link_s, compute_s
    keep = []
    for counter, e0, e1 in _pending:
        if finished_only and not e1.query():
            keep.append((counter, e0, e1))
            continue
        e1.synchronize()
        sec = e0.elapsed_time(e1) / 1e3
        if counter == "link":
            link_s += sec
        else:
            compute_s += sec
    _pending[:] = keep


def snapshot() -> dict:
    """The counters, after waiting for every pending event pair."""
    with _lock:
        _fold(False)
        return {"link_s": link_s, "link_bytes": link_bytes,
                "compute_s": compute_s, "compute_calls": compute_calls}


class _Span:
    """Times one transfer or one group of launches on `device`: a CUDA
    event pair on its current stream, or perf_counter on the CPU."""

    def __init__(self, counter: str, device: torch.device):
        self.counter = counter
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(self.stream)
        else:
            self.t0 = time.perf_counter()

    def end(self, nbytes: int = 0) -> None:
        global link_s, link_bytes, compute_s, compute_calls
        if self.cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(self.stream)
        else:
            sec = time.perf_counter() - self.t0
        with _lock:
            if self.counter == "link":
                link_bytes += nbytes
            else:
                compute_calls += 1
            if self.cuda:
                _pending.append((self.counter, self.e0, e1))
                if len(_pending) >= _DRAIN_AT:
                    _fold(True)
            elif self.counter == "link":
                link_s += sec
            else:
                compute_s += sec


def put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on device (a timed upload when enabled)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if not enabled:
        return t.to(device)
    device = torch.device(device)
    span = _Span("link", device)
    out = t.to(device)
    span.end(t.numel() * t.element_size())
    return out


def get(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array (a timed download when enabled)."""
    if not enabled:
        return t.cpu().numpy()
    span = _Span("link", t.device)
    out = t.cpu().numpy()
    span.end(out.nbytes)
    return out


def compute(thunk, device: torch.device):
    """thunk(), whose launches run on device; when enabled, their time
    counts as device computation (one call).  Its inputs should be on
    the device already (put) for the attribution to be honest."""
    if not enabled:
        return thunk()
    span = _Span("compute", torch.device(device))
    out = thunk()
    span.end()
    return out


def timed(wrapper):
    """Decorate a kernel wrapper whose first argument is a tensor on the
    device it runs on: when enabled, each call is one compute() span
    (the kernel's launch on a CUDA device, its plain version on the
    CPU); disabled, a plain call-through."""
    @functools.wraps(wrapper)
    def call(*args, **kw):
        if not enabled:
            return wrapper(*args, **kw)
        return compute(lambda: wrapper(*args, **kw), args[0].device)
    return call
