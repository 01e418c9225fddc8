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

Spans and counters name the host's work between the device's:

- ``span(name, parent=None)``: a context manager that, enabled, keeps
  one record of the host's wall between its entry and exit in an
  in-memory log (``Span``: request, id, parent, thread, name, t0_ns,
  t1_ns, counts), stamped with ``time.time_ns()``, the clock
  torch.profiler stamps its own events with.  Its parent is the
  innermost span open on the same thread, or the one passed (a pool
  thread's job passes ``current()`` of the thread that submitted it).
  A span with neither is a root and opens a request: the wave engine's
  entry points open ``encode`` and ``decode``.  Names are constants
  ``"<layer>/<what>"`` (PERF.md lists them); ``put``/``get`` open
  ``link/put``/``link/get`` and a ``timed`` wrapper ``kernel/<walk>``.
- ``count(name, n)``: adds n to the counts of the request the thread's
  innermost open span belongs to (its root's record), e.g. the symbols
  a kernel wrapper's caller launches a walk over, counted on the host
  beside the call, under ``walk_symbols/<walk>``.
- ``spans()``: a copy of the log, at most MAX_SPANS records, oldest
  first by closing time.  ``reset()`` leaves it alone.

Disabled, ``span`` returns one shared null context and ``count``
returns at once: no clock read, no allocation, no call into torch.
The program never opens a torch.profiler range, so a profile of the
device holds only the program's kernels and copies.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
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

MAX_SPANS = 65536     # records the span log keeps (the oldest go first)
Span = collections.namedtuple(
    "Span", "request id parent thread name t0_ns t1_ns counts")
_log: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_tls = threading.local()
_NULL = contextlib.nullcontext()


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


class _Open:
    """One open span (see span()); appends its record on exit."""

    __slots__ = ("name", "id", "parent", "root", "counts", "t0")

    def __init__(self, name: str, parent: "_Open | None"):
        self.name = name
        self.parent = parent

    def __enter__(self) -> "_Open":
        stack = _stack()
        parent = self.parent or (stack[-1] if stack else None)
        self.parent = parent
        self.id = next(_ids)
        self.root = parent.root if parent is not None else self
        self.counts = {} if parent is None else None
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        _stack().pop()
        p = self.parent
        rec = Span(self.root.id, self.id, None if p is None else p.id,
                   threading.get_ident(), self.name, self.t0, t1,
                   self.counts)
        with _lock:
            _log.append(rec)
        return False


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def span(name: str, parent: _Open | None = None):
    """A context manager timing the host's work under name (see the
    module's docstring); the shared null context when disabled."""
    if not enabled:
        return _NULL
    return _Open(name, parent)


def current() -> _Open | None:
    """The innermost span open on this thread (None when disabled or
    when none is): what a job handed to a pool thread passes as its
    span's parent."""
    if not enabled:
        return None
    st = _stack()
    return st[-1] if st else None


def count(name: str, n: int) -> None:
    """Add n to name in the counts of the current request's root (no
    request open on this thread: nothing)."""
    if not enabled:
        return
    st = _stack()
    if st:
        counts = st[-1].root.counts
        with _lock:
            counts[name] = counts.get(name, 0) + n


def spans() -> list:
    """A copy of the span log (Span records, in the order they closed)."""
    with _lock:
        return list(_log)


def put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on device (a timed upload when enabled)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if not enabled:
        return t.to(device)
    device = torch.device(device)
    with span("link/put"):
        sp = _Span("link", device)
        out = t.to(device)
        sp.end(t.numel() * t.element_size())
    return out


def get(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array (a timed download when enabled)."""
    if not enabled:
        return t.cpu().numpy()
    with span("link/get"):
        sp = _Span("link", t.device)
        out = t.cpu().numpy()
        sp.end(out.nbytes)
    return out


def compute(thunk, device: torch.device):
    """thunk(), whose launches run on device; when enabled, their time
    counts as device computation (one call).  Its inputs should be on
    the device already (put) for the attribution to be honest."""
    if not enabled:
        return thunk()
    sp = _Span("compute", torch.device(device))
    out = thunk()
    sp.end()
    return out


def timed(walk: str):
    """Decorator of a kernel wrapper whose first argument is a tensor on
    the device it runs on: when enabled, each call is one compute()
    span inside a ``kernel/<walk>`` span; disabled, a plain
    call-through."""
    name = "kernel/" + walk

    def deco(wrapper):
        @functools.wraps(wrapper)
        def call(*args, **kw):
            if not enabled:
                return wrapper(*args, **kw)
            with span(name):
                return compute(lambda: wrapper(*args, **kw), args[0].device)
        return call
    return deco
