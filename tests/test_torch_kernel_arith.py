"""The quotient arithmetic the CUDA encode walks rely on, proved on the CPU.

csrc/rc_encode.cu divides range by tot with a reciprocal
(rc_torch.rc_recip / rc_quotient mirror it), and csrc/rans_encode.cu
steps rANS states with encoder symbols in place of a divide
(rans_torch.enc_symbols / enc_step mirror it).  Neither kernel runs
here; these tests hold the mirrored formulas exact against plain integer
division, the JAX package's own forms (rc_jax._div_u32_u16,
rans_jax.build_enc_tables) and the host's lane-31 tail walk, over every
denominator the kernels can meet.  chip_smoke.py holds the kernels
themselves against the plain walks on the card.
"""

import numpy as np
import pytest

from fqzcomp5_tpu.ops import rans_jax, rc_jax
from fqzcomp5_tpu_torch import engine_cuda
from fqzcomp5_tpu_torch.ops import rans_torch, rc_torch

M32 = 0xFFFFFFFF
TOTS = np.arange(1, 1 << 16, dtype=np.uint64)    # every tot a step can have


def _edge_numerators(d: np.ndarray) -> np.ndarray:
    """(len(d), 8) u32 numerators at each divisor's edges: 0, d-1, d,
    d+1, the last multiple of d below 2^32 and its neighbours, 2^32-1."""
    top = (np.uint64(M32) // d) * d
    cols = [np.zeros_like(d), d - 1, d, d + 1, top - 1, top,
            np.minimum(top + 1, M32), np.full_like(d, M32)]
    return np.stack(cols, 1).astype(np.uint64)


def test_rc_recip_is_floor_of_2_pow_32_over_tot():
    want = np.minimum((1 << 32) // TOTS.astype(object), M32).astype(np.uint64)
    assert np.array_equal(rc_torch.rc_recip(TOTS), want)


@pytest.mark.parametrize("kind", ["edges", "random"])
def test_rc_quotient_is_exact_for_every_tot(kind):
    if kind == "edges":
        n = _edge_numerators(TOTS)
    else:
        rng = np.random.default_rng(7)
        n = rng.integers(0, 1 << 32, (len(TOTS), 48), dtype=np.uint64)
    d = np.broadcast_to(TOTS[:, None], n.shape)
    assert np.array_equal(rc_torch.rc_quotient(n, d), n // d)


def test_rc_quotient_needs_its_one_correction():
    """umulhi alone is one short for some (range, tot): the compare-and-add
    in the kernel is needed, and the tests above exercise it."""
    n = _edge_numerators(TOTS)
    d = np.broadcast_to(TOTS[:, None], n.shape)
    q0 = (n * rc_torch.rc_recip(d)) >> np.uint64(32)
    short = q0 != n // d
    assert short.any()
    assert np.array_equal(q0[short] + 1, (n // d)[short])


def test_rc_quotient_equals_the_jax_range_coder_divide():
    rng = np.random.default_rng(11)
    d = rng.integers(1, 1 << 16, 1 << 16, dtype=np.uint64)
    n = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    n[:4096] = _edge_numerators(d[:512]).reshape(-1)
    ju = np.asarray(rc_jax._div_u32_u16(
        n.astype(np.uint32), d.astype(np.float32), d.astype(np.uint32)))
    assert np.array_equal(rc_torch.rc_quotient(n, d), ju.astype(np.uint64))


def _every_f_table(shift: int, seed: int):
    """Freq rows (M, 256) holding each f in [1, M] once, at a random
    symbol after a random start (start + f <= M), and the same entries
    packed as the kernels read them, (M, 257) with the sentinel."""
    M = 1 << shift
    rng = np.random.default_rng(seed)
    f = np.arange(1, M + 1)
    sym = rng.integers(1, 256, M)
    start = (rng.random(M) * (M - f + 1)).astype(np.int64)
    freqs = np.zeros((M, 256), np.int64)
    freqs[np.arange(M), 0] = start
    freqs[np.arange(M), sym] = f
    return freqs, rans_torch.build_packed_tables(freqs, shift)


@pytest.mark.parametrize("shift", [10, 12])
def test_enc_symbols_equal_the_encoder_tables(shift):
    freqs, packed = _every_f_table(shift, shift)
    # symbols that occur: an absent symbol's packed start may reach into
    # the f field, and no walk reads its entry
    used = freqs > 0
    got = rans_torch.enc_symbols(packed[:, :256], shift)
    for want in (rans_torch.build_enc_tables(freqs, shift),
                 rans_jax.build_enc_tables(freqs, shift)):
        for name, g, w in zip(("x_max", "rcp", "rsh", "bias", "cmpl"),
                              got, want):
            assert np.array_equal(g[used] & M32,
                                  np.asarray(w, np.int64)[used]), name
    # the no-op sentinel (f = 1 << shift, start 0) leaves every state alone
    sent = rans_torch.enc_symbols(packed[:1, 256], shift)
    R = np.arange(1 << 15, 1 << 31, 9973, dtype=np.int64)
    nxt, emit = rans_torch.enc_step(R, [a[:, None] for a in sent])
    assert not emit.any() and np.array_equal(nxt[0], R)


def _divide_step(R, f, start, shift):
    emit = (R >> (31 - shift)) >= f
    R = np.where(emit, R >> 16, R)
    q = R // f
    return ((q << shift) + R - q * f + start) & M32, emit


@pytest.mark.parametrize("shift", [10, 12])
def test_enc_step_equals_the_divide_for_every_f(shift):
    """Every f in [1, 1 << shift], states across both renormalisation
    classes (kept: [2^15, x_max]; emitting: (x_max, 2^31)) at their edges,
    at the quotient's steps in each, and a seeded sample."""
    _, packed = _every_f_table(shift, 100 + shift)
    P = packed[:, :256].astype(np.int64) & M32
    f = (P >> shift).max(1)
    start = np.take_along_axis(P, (P >> shift).argmax(1)[:, None], 1)[:, 0]
    start &= (1 << shift) - 1
    lo, top = 1 << 15, (1 << 31) - 1
    x_max = (f << (31 - shift)) - 1
    k_lo = -(-lo // f)                    # first multiple of f in the class
    k_hi = x_max // f
    e_lo = ((x_max + 1) >> 16) // f + 1   # emitting: (R >> 16) crosses k*f
    cols = [np.full_like(f, lo), np.full_like(f, lo + 1), x_max - 1, x_max,
            x_max + 1, np.full_like(f, top), k_lo * f, k_lo * f + 1,
            k_hi * f - 1, k_hi * f, (e_lo * f) << 16, ((e_lo * f) << 16) - 1,
            ((e_lo * f + 1) << 16) - 1]
    rng = np.random.default_rng(shift)
    R = np.concatenate([np.stack(cols, 1),
                        rng.integers(lo, top + 1, (len(f), 64))], 1)
    R = np.clip(R, lo, top)               # only renormalised states
    sym = rans_torch.enc_symbols(
        (f[:, None] << shift) | start[:, None], shift)
    got, got_emit = rans_torch.enc_step(R, sym)
    want, want_emit = _divide_step(R, f[:, None], start[:, None], shift)
    assert got_emit.any() and not got_emit.all()
    assert np.array_equal(got_emit, want_emit)
    assert np.array_equal(got, want)


def _o1_freqs(arr: np.ndarray, shift: int) -> np.ndarray:
    """Order-1 freq rows of arr's (ctx, sym) pairs, each row summing to
    1 << shift (or zero), every seen pair at least 1."""
    counts = np.zeros((256, 256), np.int64)
    np.add.at(counts, (arr[:-1], arr[1:]), 1)
    counts[0, arr[0]] += 1
    tot = 1 << shift
    rs = counts.sum(1, keepdims=True)
    k = (counts > 0).sum(1, keepdims=True)
    f = np.where(counts > 0, 1 + counts * (tot - k) // np.maximum(rs, 1), 0)
    am = f.argmax(1)
    f[np.arange(256), am] += np.where(rs[:, 0] > 0, tot - f.sum(1), 0)
    return f


@pytest.mark.parametrize("shift,seed", [(10, 1), (12, 2), (12, 3)])
def test_enc_step_reproduces_the_lane31_tail_walk(shift, seed):
    """The host's lane-31 tail (engine_cuda._lane31_tail) walks the same
    encoder-symbol formulas; stepping enc_symbols of the packed entries
    gives its seed state and words."""
    rng = np.random.default_rng(seed)
    n = 32 * int(rng.integers(40, 80)) + int(rng.integers(1, 32))
    alpha = np.frombuffer(b"ACGTN" if seed % 2 else bytes(range(30, 72)),
                          np.uint8)
    arr = rng.choice(alpha, n)
    arr[-8:] = alpha[0]                   # a long run: a dominant pair
    freqs = _o1_freqs(arr, shift)
    R31, words = engine_cuda._lane31_tail(arr, freqs, shift)
    assert words or R31 != rans_torch.RANS_L
    packed = rans_torch.build_packed_tables(freqs[None], shift)[0]
    lo = 32 * (n // 32) - 1
    flat = arr[lo:n - 1].astype(np.int64) * 256 + arr[lo + 1:n]
    sym = rans_torch.enc_symbols(packed[flat], shift)
    R = np.int64(rans_torch.RANS_L)
    mine = []
    for k in range(len(flat) - 1, -1, -1):
        prev = R
        R, emit = rans_torch.enc_step(R, [a[k] for a in sym])
        if emit:
            mine.append(int(prev) & 0xFFFF)
    assert int(R) == R31 and mine == words
