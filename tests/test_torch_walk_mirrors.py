"""The redesigned order-1 decode walk and 128-slot model evolution, as
numpy mirrors, held on the CPU against the plain walks, the JAX package
and the native codecs.

csrc/rans_decode.cu decodes order-1 streams through compact tables (a u8
slot table per context, a packed (f, start) word per context and
symbol) that its prologue builds from the s3 LUTs; rans_torch.
o1_compact_tables / decode_o1_compact mirror that form and walk.
csrc/fqz_evolve.cu's warp layout keeps a running prefix beside each
lane's slots instead of reducing across the warp each step;
fqz_model_torch.evolve_prefix_mirror mirrors it.  Neither kernel runs
here; chip_smoke.py holds the kernels themselves against the plain walks
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import fqz_model_jax
from fqzcomp5_tpu_torch import engine_cuda
from fqzcomp5_tpu_torch.codecs import host
from fqzcomp5_tpu_torch.ops import fqz_model_torch, rans_cuda_dec, rans_torch
from fqzcomp5_tpu_torch.utils import varint

CPU = torch.device("cpu")


def _normalise(counts, shift):
    """Rows of counts -> rows summing to 1 << shift, every counted
    symbol at least 1, rows of zeros left zero."""
    tot = 1 << shift
    c = counts.astype(np.int64)
    rs = c.sum(-1, keepdims=True)
    k = (c > 0).sum(-1, keepdims=True)
    f = np.where(c > 0, 1 + (c * (tot - k)) // np.maximum(rs, 1), 0)
    am = f.argmax(-1)[..., None]
    fix = np.where(rs > 0, tot - f.sum(-1, keepdims=True), 0)
    np.put_along_axis(f, am, np.take_along_axis(f, am, -1) + fix, -1)
    return f


def _o1_case(rng, A, shift, B=3, T=48):
    """B order-1 streams of T steps a lane over bytes 0..A-1, encoded by
    the plain walk: (words, R0, s3, t_real, syms (B, T, 32))."""
    sym = rng.integers(0, A, (B, T, 32))
    sym[:, :4] = np.arange(4 * 32).reshape(4, 32) % A   # every byte used
    flat = sym.copy()
    flat[:, 1:] += sym[:, :-1] * 256
    counts = np.stack([np.bincount(f.reshape(-1), minlength=65536)
                       for f in flat])
    freqs = _normalise(counts.reshape(B, 256, 256), shift)
    Rf, w, nw = rans_torch.encode_walk_ref(
        torch.from_numpy(flat.astype(np.int32)),
        rans_torch.tables_from_numpy(freqs, "freqs", shift=shift), shift)
    w = w.numpy()
    nw = nw.numpy()
    words = np.zeros((B, int(nw.max())), np.int16)
    for b, n in enumerate(nw):
        words[b, :n] = w[b, w.shape[1] - n:]
    s3 = rans_torch.build_s3(freqs, shift).reshape(B, -1).view(np.int32)
    return words, Rf.numpy(), s3, np.full(B, T, np.int32), sym


def _both(words, R0, s3, t_real, T, shift):
    want = rans_torch.decode_o1_ref(*(torch.from_numpy(np.ascontiguousarray(
        a)) for a in (words, R0, s3, t_real)), T, shift)
    got = rans_torch.decode_o1_compact(words, R0, s3, t_real, T, shift)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1].view(np.int32), want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())
    return got


@pytest.mark.parametrize("shift,A,route", [
    (12, 51, "shared"), (12, 52, "global"),     # the shared-memory fit
    (10, 140, "shared"), (10, 141, "global"),
    (12, 256, "s3"),                            # no code left for zero
])
def test_o1_compact_walk_equals_plain(shift, A, route):
    rng = np.random.default_rng(A + shift)
    words, R0, s3, t_real, sym = _o1_case(rng, A, shift)
    routes = {rans_torch.o1_compact_tables(r.view(np.uint32), shift)[1]
              for r in s3}
    assert routes == {route}
    got = _both(words, R0, s3, t_real, 48, shift)
    assert np.array_equal(got[0], sym)
    # ragged lengths (one empty stream) and a word row cut short, so
    # that lanes read past its end
    t_real = np.array([48, 17, 0], np.int32)
    _both(words, R0, s3, t_real, 48, shift)
    _both(words[:, :40], R0, s3, t_real, 48, shift)


def test_o1_compact_tables_zero_entries():
    """A row summing below tot (only a corrupt table gives one) leaves
    zero s3 entries: they decode byte 0 with f = tot and bias 0, through
    the zero code A."""
    rng = np.random.default_rng(3)
    words, R0, s3, t_real, _ = _o1_case(rng, 6, 12)
    s3 = s3.copy().reshape(3, 256, 4096)
    s3[:, 1, 3000:] = 0
    s3[:, 0, 4000:] = 0
    s3 = s3.reshape(3, -1)
    alpha, route, slot, ptab = rans_torch.o1_compact_tables(
        s3[0].view(np.uint32), 12)
    assert route == "shared" and (slot[1, 3000:] == len(alpha)).all()
    _both(words, R0, s3, t_real, 48, 12)


def _markov(rng, n, pdom):
    reset = rng.random(n) >= pdom
    reset[0] = True
    pos = np.flatnonzero(reset)
    seg = np.cumsum(reset) - 1
    base = rng.integers(0, 4, len(pos))
    return ((base[seg] + np.arange(n) - pos[seg]) % 4).astype(np.uint8)


def test_o1_compact_walk_decodes_native_streams(monkeypatch):
    """Native-encoded streams of every route (quality, DNA, one symbol,
    256 bytes, 200 bytes, a single-symbol context at shift 12) decode
    through the engine with the mirror in place of the kernel, equal to
    the plain walk at every launch and to the native decoder."""
    rng = np.random.default_rng(11)
    skew = _markov(rng, 60000, 0.995)
    pos = rng.integers(0, len(skew) - 1, 20)
    skew[pos], skew[pos + 1] = 250, 251
    datas = [(np.cumsum(rng.integers(-2, 3, 7001)) % 40 + 35),
             rng.choice(np.frombuffer(b"ACGT", np.uint8), 5003),
             np.full(4500, 65), rng.integers(0, 256, 6000),
             rng.integers(0, 200, 30000), skew]
    datas = [np.asarray(d, np.uint8).tobytes() for d in datas]
    seen = []

    def mirror(words, R0, s3, t_real, T, shift):
        got = _both(*(a.numpy() for a in (words, R0, s3, t_real)), T, shift)
        seen.extend(rans_torch.o1_compact_tables(r.view(np.uint32), shift)[1]
                    for r in s3.numpy())
        return tuple(torch.from_numpy(a.view(np.int32) if a.dtype ==
                                      np.uint32 else a) for a in got)

    monkeypatch.setattr(rans_cuda_dec, "decode_o1", mirror)
    pays = engine_cuda.encode_o1_batch(datas, CPU)
    assert engine_cuda.decode_o1_batch(pays, [len(d) for d in datas],
                                       CPU) == datas
    assert {"shared", "global", "s3"} <= set(seen)
    for d, p in zip(datas, pays):
        framed = bytes([0x05]) + varint.put_u32(len(d)) + p
        assert host.rans_uncompress(framed) == d


def _ladder():
    """Every symbol from 127 down to 0 in a run one step longer than the
    one before: each climbs the bubble order from its slot to the front,
    across every lane boundary, and tot passes the halving bound many
    times."""
    return np.concatenate([np.full(130 + i, 127 - i) for i in range(128)])


def _evolve_cases():
    rng = np.random.default_rng(9)
    lad = _ladder()[None, :]
    z = np.minimum(rng.zipf(1.3, (3, 5000)) - 1, 95)
    return {
        "ladder": (lad, np.array([lad.shape[1]]), np.array([128]), 128),
        "zipf96": (z, np.array([5000, 4321, 17]), np.array([96, 96, 40]),
                   128),
        "max_sym1": (np.zeros((2, 300), np.int64), np.array([300, 5]),
                     np.array([1, 1]), 128),
        "uniform128": (rng.integers(0, 128, (2, 4400)), np.array([4400, 4400]),
                       np.array([128, 128]), 128),
        "full256": (rng.integers(0, 256, (2, 4600)), np.array([4600, 999]),
                    np.array([256, 200]), 256),
    }


@pytest.mark.parametrize("name", list(_evolve_cases()))
def test_evolve_prefix_mirror_equals_plain_and_jax(name):
    sp, counts, ms, cap = _evolve_cases()[name]
    sp = np.minimum(sp, ms[:, None] - 1).astype(np.uint8) \
        if name != "full256" else sp.astype(np.uint8)
    counts = counts.astype(np.int32)
    ms = ms.astype(np.int32)
    cf, tot = fqz_model_torch.evolve_prefix_mirror(sp, counts, ms, cap)
    ref = fqz_model_torch.evolve_ref(torch.from_numpy(sp),
                                     torch.from_numpy(counts),
                                     torch.from_numpy(ms), cap)
    assert np.array_equal(cf, ref[0].numpy())
    assert np.array_equal(tot, ref[1].numpy())
    want = fqz_model_jax.evolve(jnp.asarray(sp.astype(np.int32)),
                                jnp.asarray(counts), jnp.asarray(ms),
                                jnp.int32(16), lanes=cap)
    T = sp.shape[1]
    m = np.arange(T)[None, :] < counts[:, None]
    u = cf.view(np.uint32)
    for g, w in zip((u >> 16, u & 0xFFFF, tot.view(np.uint32)), want):
        assert np.array_equal(g[m], np.asarray(w)[:, :T][m])
