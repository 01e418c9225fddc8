"""Plain PyTorch version of the pass-3 range-coder encode walk.

The adaptive codecs (fqz-qual, SEQ) serialise through the
carry-counting range coder (native/rc.h; the JAX package's
``ops/rc_jax.py``).  ``encode_walk_ref`` walks B independent coders over
their (cum, freq, tot) triples and returns the bytes each emitted: it is
the reference the CUDA kernel (``rc_cuda.encode_walk``,
``csrc/rc_encode.cu``) is held against, and the route that wrapper
takes for tensors on the CPU.

Inputs are the layout the kernel reads: flat int32 vectors ``cf``
(``cum << 16 | freq``) and ``tot`` in stream order, and per stream the
offset of its first step in them and the number of steps to walk.  The
coder state (low, range, cache, ffnum, carry) comes in and goes out as a
(5, B) int32 tensor of u32 bit patterns, so a long stream walks in
chunks.  As in ``rans_torch``, u32 values ride in int64 masked to 32
bits: torch has no uint32 arithmetic on the CPU.

``finish_events`` is a copy of ``rc_jax.finish_events`` (the five
finish_encode shift_lows, on the host), which cannot be imported
without importing jax.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
K_TOP = 1 << 24
K_THRESH = 0xFF << 24


@contextlib.contextmanager
def single_thread(device: torch.device):
    """Run a per-step loop of tiny CPU ops on one intra-op thread: with
    torch's thread pool such loops run about 2.5x slower.  A no-op for
    other devices."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def init_state(B: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(5, B) int32 initial coder state: low 0, range 0xFFFFFFFF."""
    st = torch.zeros((5, B), dtype=torch.int32, device=device)
    st[1] = -1
    return st


def cap_for(n_max: int, ff_max: int) -> int:
    """Output bytes a stream can emit in a chunk of n_max steps, given
    ff_max pending 0xFF-run bytes carried in from the previous chunk:
    at most two shift_lows a step, each emitting one byte or deferring
    one into the run, plus the carried run."""
    return 2 * n_max + ff_max + 1


def rc_recip(tot) -> np.ndarray:
    """The CUDA walk's reciprocal of each tot in [1, 2^16), in its u32
    arithmetic (csrc/rc_encode.cu rc_recip): floor(2^32 / tot), and
    2^32 - 1 for tot 1.  Returns uint64 values."""
    d = np.asarray(tot, np.uint64)
    m = np.uint64(M32) // np.maximum(d, 1)
    m = np.where(np.uint64(M32) - m * d == d - 1, m + 1, m)
    return np.where(d <= 1, np.uint64(M32), m)


def rc_quotient(rng, tot) -> np.ndarray:
    """range // tot as the CUDA walk computes it: q = umulhi(range,
    rc_recip(tot)), which is the quotient or one less, then one
    compare-and-add.  u32 range, tot in [1, 2^16); uint64 results."""
    n = np.asarray(rng, np.uint64)
    d = np.asarray(tot, np.uint64)
    q = (n * rc_recip(d)) >> np.uint64(32)
    return q + (n - q * d >= d)


def encode_walk_ref(cf: torch.Tensor, tot: torch.Tensor, off: torch.Tensor,
                    n: torch.Tensor, state: torch.Tensor, cap: int):
    """Walk B range coders.

    cf, tot: (N,) int32 -- ``cum << 16 | freq`` and ``tot`` (< 2^16) of
    every step, streams laid out contiguously; off: (B,) int64 index of
    stream b's first step; n: (B,) int32 steps to walk; state: (5, B)
    int32 carried state (``init_state`` for a fresh stream); cap: bytes
    of output room per stream (``cap_for``).

    Returns (out (B, cap) uint8, totals (B,) int32, state (5, B) int32):
    stream b emitted out[b, :totals[b]]; the rest of the row is zero.
    A shift_low that flushes emits (cache + carry) & 0xFF and then
    ffnum bytes of (carry - 1) & 0xFF (native/rc.h:92-106); carry keeps
    its full width in the state.  Raises ValueError when a stream's
    bytes exceed cap."""
    dev = cf.device
    B = off.shape[0]
    T = int(n.max()) if B else 0
    st = state.to(torch.int64) & M32
    # X = low + carry * 2^32: the carry is what low overflows into
    X = st[0] + (st[4] << 32)
    rng = st[1]
    steps = torch.arange(T, device=dev)
    valid = steps[None, :] < n.to(torch.int64)[:, None]
    idx = torch.where(valid, off[:, None] + steps[None, :], 0)
    P = cf[idx].to(torch.int64) & M32
    # padded steps code (cum 0, freq 1, tot 1): range/1*1 and low+0
    # leave the state as it is, and range stays >= 2^24, so no shift
    C = torch.where(valid, P >> 16, 0).unbind(1)
    F = torch.where(valid, P & 0xFFFF, 1).unbind(1)
    TT = torch.where(valid, tot[idx].to(torch.int64), 1).unbind(1)
    # The walk keeps only (X, range): which shift_lows flush, and what
    # they emit, follow from X at each shift and are worked out after
    # the loop.  xs/rs hold X and range after each step's update.
    xs = torch.empty((T, B), dtype=torch.int64, device=dev)
    rs = torch.empty((T, B), dtype=torch.int64, device=dev)
    with single_thread(dev):
        for t in range(T):
            q = rng // TT[t]
            X = X + C[t] * q
            rng = q * F[t]
            xs[t] = X
            rs[t] = rng
            sh = ((rng < K_TOP).to(torch.int64) + (rng < 1 << 16)) << 3
            rng = rng << sh
            X = torch.where(sh > 0, (X << sh) & M32, X)
    out, totals, cache, ffnum = _emit(xs.T, rs.T, st[2], st[3], cap)
    st = torch.stack([X & M32, rng, cache, ffnum, X >> 32]) & M32
    st = torch.where(st >= 1 << 31, st - (1 << 32), st).to(torch.int32)
    return out, totals, st


def _emit(xs: torch.Tensor, rs: torch.Tensor, cache0: torch.Tensor,
          ff0: torch.Tensor, cap: int):
    """Bytes of a walk's shift_lows.

    xs, rs: (B, T) X = low + carry * 2^32 and range after each step's
    update, before its shifts; cache0, ff0: (B,) state before the walk.
    A step shifts once while range < 2^24 and twice while range < 2^16;
    the second shift sees (X << 8) mod 2^32 (carry 0).  A shift flushes
    unless carry == 0 and low >= 0xFF000000; a flush emits (cache +
    carry) & 0xFF, then one (carry - 1) & 0xFF byte for every shift
    since the previous flush that did not flush, and makes low >> 24 the
    cache.  Returns (out (B, cap) uint8, totals (B,) int32, cache (B,),
    ffnum (B,)); raises ValueError when a stream's bytes exceed cap."""
    B, T = xs.shape
    dev = xs.device
    # shift slots in walk order: (step, first/second)
    sx = torch.stack([xs, (xs << 8) & M32], 2).reshape(B, 2 * T)
    sv = torch.stack([rs < K_TOP, rs < 1 << 16], 2).reshape(B, 2 * T)
    fl = sv & (((sx - K_THRESH) >> 24) != 0)
    nfl = torch.cumsum((sv & ~fl).to(torch.int64), 1)   # inclusive
    slot = torch.arange(2 * T, device=dev)
    last = torch.cummax(torch.where(fl, slot, -1), 1).values
    prev = torch.cat([torch.full((B, 1), -1, device=dev,
                                 dtype=torch.int64), last[:, :-1]], 1)
    cachev = (sx >> 24) & 0xFF
    has = prev >= 0
    pc = prev.clamp(min=0)
    cache_b = torch.where(has, cachev.gather(1, pc), cache0[:, None])
    ff_b = torch.where(has, nfl - nfl.gather(1, pc), nfl + ff0[:, None])
    k = torch.where(fl, 1 + ff_b, 0)
    totals = k.sum(1)
    if B and int(totals.max()) > cap:
        raise ValueError(f"range coder emitted {int(totals.max())} bytes, "
                         f"room for {cap}")
    out = torch.zeros(B * cap, dtype=torch.uint8, device=dev)
    b, e = fl.nonzero(as_tuple=True)
    start = b * cap + (torch.cumsum(k, 1) - k)[b, e]
    carry = sx[b, e] >> 32
    out[start] = ((cache_b[b, e] + carry) & 0xFF).to(torch.uint8)
    runs = ff_b[b, e]
    nrun = int(runs.sum())
    if nrun:
        first = torch.repeat_interleave(start + 1, runs)
        run0 = torch.cumsum(runs, 0) - runs
        within = (torch.arange(nrun, device=dev)
                  - torch.repeat_interleave(run0, runs))
        out[first + within] = torch.repeat_interleave(
            (carry - 1) & 0xFF, runs).to(torch.uint8)
    if T:
        has_f = last[:, -1] >= 0
        lf = last[:, -1:].clamp(min=0)
        cache = torch.where(has_f, cachev.gather(1, lf)[:, 0], cache0)
        ffnum = torch.where(has_f, nfl[:, -1] - nfl.gather(1, lf)[:, 0],
                            nfl[:, -1] + ff0)
    else:
        cache, ffnum = cache0, ff0
    return out.reshape(B, cap), totals.to(torch.int32), cache, ffnum


def finish_events(state) -> list[bytes]:
    """The 5 finish_encode shift_lows of every stream, on the host.
    state: (5, B) u32 values (a tensor of int32 bit patterns, or any
    5-sequence of arrays)."""
    if isinstance(state, torch.Tensor):
        state = state.cpu().numpy().view(np.uint32)
    low, rng, cache, ffnum, carry = [np.asarray(x) for x in state]
    B = low.shape[0]
    tails = []
    for b in range(B):
        lo, ca, ff, cy = int(low[b]), int(cache[b]), int(ffnum[b]), \
            int(carry[b])
        out = []
        for _ in range(5):
            if lo < (255 << 24) or cy:
                out.append((ca + cy) & 0xFF)
                out.extend([(cy - 1) & 0xFF] * ff)
                ca = (lo >> 24) & 0xFF
                ff = 0
                cy = 0
            else:
                ff += 1
            lo = (lo << 8) & 0xFFFFFFFF
        tails.append(bytes(out))
    return tails
