"""The port's boundary-table decode route (FQZ5_DEC_V3) against the JAX
package, on the CPU: the table builders, the five Pallas decode walks of
``rans_pallas_dec.py`` (run with ``interpret=True``) against
``ops/rans_bnd_dec.py``, and the engine's decodes over both table forms.
Integer coding, so every comparison is exact (tolerance 0).  Streams are
made from numpy seeds and encoded by the port's own encoder (its plain
walks), as ``tests/test_rans_pallas_dec.py`` does with the JAX engine's.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import rans_pallas_dec as rpd
from fqzcomp5_tpu_torch import engine_cuda
from fqzcomp5_tpu_torch.ops import (rans_bnd_dec, rans_bnd_torch,
                                    rans_torch)

CPU = torch.device("cpu")
DNA = np.frombuffer(b"ACGT", np.uint8)


def _qual(rng, n, lo=36, width=40):
    """Random-walk quality bytes lo..lo+width-1."""
    return (np.cumsum(rng.integers(-2, 3, n)) % width + lo).astype(np.uint8)


def _o0_streams(rng, kind, B=4):
    """B ragged byte streams whose alphabet falls in the S bucket of
    `kind`, the second a single-symbol stream."""
    out = []
    for b in range(B):
        n = int(rng.integers(700, 2600))
        if b == 1:
            d = np.full(n, {"s16": 9, "s64": 40, "s256": 67}[kind], np.uint8)
        elif kind == "s16":
            d = rng.choice(np.arange(2, 12, dtype=np.uint8), n)
        elif kind == "s64":
            d = _qual(rng, n, lo=2, width=44)
        else:
            d = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                           p=[.3, .2, .2, .25, .05])
        out.append(d.tobytes())
    return out


def _dec_prep(payloads, order):
    """(s3 LUTs, R0 (B, 32) uint32, words (B, W) uint16, shifts) from
    the native dec prep of engine payloads."""
    L = engine_cuda._lib()
    s3s, bodies, shifts = [], [], []
    for p in payloads:
        arr = np.frombuffer(p, np.uint8)
        s3 = np.empty(256 << 12 if order else 4096, np.uint32)
        sh = ctypes.c_int(12)
        if order:
            used = L.fqz5_rans_o1_dec_prep(
                engine_cuda._ptr(arr), len(arr),
                s3.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.byref(sh))
        else:
            used = L.fqz5_rans_o0_dec_prep(
                engine_cuda._ptr(arr), len(arr),
                s3.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        assert used > 0
        s3s.append(s3[:256 << sh.value] if order else s3)
        shifts.append(sh.value)
        bodies.append(arr[used:])
    R0, words = engine_cuda._word_rows(bodies)
    return s3s, R0, words, shifts


def _words128(words):
    """(B, W) uint16 rows -> the JAX layout (B, W128, 128) int32, with
    spare chunks for the Pallas kernels' window prefetch."""
    B, W = words.shape
    W128 = (W + 127) // 128 + 3
    out = np.zeros((B, W128 * 128), np.int32)
    out[:, :W] = words
    return out.reshape(B, W128, 128)


def test_table_builders_equal_jax():
    rng = np.random.default_rng(1)
    for kind, S in (("s16", 16), ("s64", 64), ("s256", 256)):
        datas = _o0_streams(rng, kind)
        freqs = np.stack([engine_cuda.o0_prep(d)[1] for d in datas])
        s3s, _, _, _ = _dec_prep(engine_cuda.encode_o0_batch(datas, CPU), 0)
        # the single-symbol stream's f << 20 wrapped in its s3 LUT
        assert (s3s[1] >> 20 == 0).all()
        got = rans_bnd_torch.freqs_from_s3(np.stack(s3s), 12)[:, 0]
        assert np.array_equal(got, freqs)
        assert np.array_equal(rans_bnd_torch.build_dec_tables(freqs, 12, S),
                              rpd.build_dec_tables(freqs, 12, S))
        if S <= 64:
            assert np.array_equal(
                rans_bnd_torch.build_dec_tables_p(freqs, 12, S),
                rpd.build_dec_tables_p(freqs, 12, S))
        tab, f0, S2, packed = rans_bnd_torch.o0_tables(np.stack(s3s))
        assert (S2, packed) == (S if kind != "s64" else 48, S <= 64)
        assert np.array_equal(f0, freqs[:, 0])
        x = rng.integers(0, 1 << 30, (8, 5, 3)).astype(np.int32)
        assert np.array_equal(rans_bnd_torch.expand4(x), rpd.expand4(x))
    # order-1: DNA-like (A = 4 without byte 0), quality-like (A = 45),
    # and uniform bytes (A = 256: the counter form, byte 0 a symbol)
    for datas in ([rng.choice(DNA, 3000).tobytes() for _ in range(3)],
                  [_qual(rng, 3000).tobytes(), bytes([70]) * 2000],
                  [rng.integers(0, 256, 9000).astype(np.uint8).tobytes()]):
        preps = [engine_cuda.o1_prep(d) for d in datas]
        for shift in {p[2] for p in preps}:
            grp = [k for k, p in enumerate(preps) if p[2] == shift]
            freqs = np.stack([preps[k][1] for k in grp])
            s3s, _, _, _ = _dec_prep(
                engine_cuda.encode_o1_batch([datas[k] for k in grp], CPU), 1)
            rec = rans_bnd_torch.freqs_from_s3(np.stack(s3s), shift)
            used = freqs.any(axis=2)
            assert np.array_equal(rec[used], freqs[used])
            want = rpd.build_o1_dense_tables(freqs, shift)
            got = rans_bnd_torch.build_o1_dense_tables(freqs, shift)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
            assert got[2:] == want[2:]


def _o0_case(kind, seed):
    """JAX-layout inputs of one order-0 case (8 streams, 2 rows of 4)."""
    rng = np.random.default_rng(seed)
    datas = _o0_streams(rng, kind, B=8)
    s3s, R0, words, _ = _dec_prep(engine_cuda.encode_o0_batch(datas, CPU), 0)
    freqs = rans_bnd_torch.freqs_from_s3(np.stack(s3s), 12)[:, 0]
    treal = np.array([len(d) // 32 for d in datas], np.int32)
    return datas, _words128(words), freqs, R0.view(np.int32), treal


def _check_syms(syms, datas, four):
    syms = np.asarray(syms)
    for b, d in enumerate(datas):
        t = len(d) // 32
        got = (syms[:t, b // 4, (b % 4) * 32:(b % 4 + 1) * 32] if four
               else syms[:t, b, :32])
        assert np.array_equal(got.reshape(-1).astype(np.uint8),
                              np.frombuffer(d, np.uint8)[:t * 32]), b


def _same(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for a, b in zip(jax_out, port_out):
        a = np.asarray(a)
        assert b.dtype == torch.int32 and a.shape == tuple(b.shape)
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("S", [16, 256])
def test_decode_walk_v1_equals_jax(S):
    datas, words128, freqs, R0, treal = _o0_case(f"s{S}", 10 + S)
    R0_128 = np.zeros((len(datas), 128), np.int32)
    R0_128[:, :32] = R0
    R0_128[:, 40] = 12345          # a lane without state keeps its R0
    tab = rpd.build_dec_tables(freqs, 12, S)
    f0 = freqs[:, :1].astype(np.int32)
    T = int(treal.max())
    want = rpd.decode_walk(words128, tab, f0, R0_128, treal, T=T, shift=12,
                           S=S, interpret=True)
    t = torch.from_numpy
    got = rans_bnd_dec.decode_walk(t(words128), t(tab), t(f0), t(R0_128),
                                   t(treal), T, shift=12, S=S)
    _same(want, got)
    _check_syms(got[0], datas, four=False)


def _four_args(words128, tab, freqs, R0, treal):
    cexp = np.ascontiguousarray(rpd.expand4(tab).transpose(1, 0, 2))
    f0exp = rpd.expand4(freqs[:, :1].astype(np.int32))[:, 0, :]
    texp = rpd.expand4(treal.reshape(-1, 1))[:, 0, :].astype(np.int32)
    R0p = R0.reshape(-1, 128)
    return words128, cexp, f0exp, R0p, texp


@pytest.mark.parametrize("name,S", [
    ("decode_walk4", 16), ("decode_walk4v3", 16), ("decode_walk4v3", 64),
    ("decode_walk4v3", 256), ("decode_walk4v4", 64)])
def test_decode_walk4_versions_equal_jax(name, S):
    datas, words128, freqs, R0, treal = _o0_case(f"s{S}", 20 + S)
    packed = name != "decode_walk4" and S <= 64
    tab = (rpd.build_dec_tables_p if packed
           else rpd.build_dec_tables)(freqs, 12, S)
    args = _four_args(words128, tab, freqs, R0, treal)
    T = int(treal.max())
    want = getattr(rpd, name)(*args, T=T, shift=12, S=S, interpret=True)
    got = getattr(rans_bnd_dec, name)(*map(torch.from_numpy, args), T,
                                      shift=12, S=S)
    _same(want, got)
    _check_syms(got[0], datas, four=True)


def _normalise(counts, shift):
    """Rows of counts -> rows summing to 1<<shift, every counted symbol
    at least 1 (rows of zeros stay zero)."""
    tot = 1 << shift
    c = counts.astype(np.int64)
    rs = c.sum(-1, keepdims=True)
    k = (c > 0).sum(-1, keepdims=True)
    f = np.where(c > 0, 1 + (c * (tot - k)) // np.maximum(rs, 1), 0)
    fix = np.where(rs[..., 0] > 0, tot - f.sum(-1), 0)
    am = f.argmax(-1)
    np.put_along_axis(f, am[..., None],
                      np.take_along_axis(f, am[..., None], -1)
                      + fix[..., None], -1)
    return f


@pytest.mark.parametrize("shift,kind", [(10, "dna"), (12, "qual")])
def test_decode_walk4v3_o1_equals_jax(shift, kind):
    """Four chunked streams at a chosen shift, one of them a single
    symbol: its contexts take the whole total, which wraps to 0 in an s3
    LUT at shift 12."""
    rng = np.random.default_rng(shift)
    datas = []
    for b in range(4):
        n = 32 * int(rng.integers(20, 60))
        # (interpret mode costs O(A^2) a step: a 12-symbol quality range)
        d = (np.full(n, 67, np.uint8) if b == 2 else
             rng.choice(DNA, n) if kind == "dna" else _qual(rng, n, 60, 12))
        datas.append(d)
    B, T = 4, max(len(d) for d in datas) // 32
    flat = np.full((B, T, 32), 256 * 256, np.int32)
    counts = np.zeros((B, 256 * 256), np.int64)
    for b, d in enumerate(datas):
        isz = len(d) // 32
        ch = d.reshape(32, isz).T.astype(np.int32)
        flat[b, 0] = ch[0]
        flat[b, 1:isz] = ch[:-1] * 256 + ch[1:]
        counts[b] = np.bincount(flat[b, :isz].reshape(-1), minlength=65536)
    freqs = _normalise(counts.reshape(B, 256, 256), shift)
    Rf, w, nw = rans_torch.encode_walk_ref(
        torch.from_numpy(flat), rans_torch.tables_from_numpy(
            freqs, "freqs", shift=shift), shift)
    w, nw = w.numpy().view(np.uint16), nw.numpy()
    words = np.zeros((B, max(1, nw.max())), np.uint16)
    for b in range(B):
        words[b, :nw[b]] = w[b, w.shape[1] - nw[b]:]
    s3 = rans_torch.build_s3(freqs, shift).reshape(B, -1)
    rec = rans_bnd_torch.freqs_from_s3(s3, shift)
    used = freqs.any(axis=2)
    assert np.array_equal(rec[used], freqs[used])
    packed, alphabet, A, A1, last0 = rpd.build_o1_dense_tables(rec, shift)
    assert A <= 64
    cexp = np.ascontiguousarray(rpd.expand4(packed).transpose(1, 0, 2))
    R0p = Rf.numpy().reshape(1, 128)
    treal = np.array([len(d) // 32 for d in datas], np.int32)
    texp = rpd.expand4(treal.reshape(-1, 1))[:, 0, :].astype(np.int32)
    args = (_words128(words), cexp, R0p, texp)
    want = rpd.decode_walk4v3_o1(*args, T=T, shift=shift, A=A, A1=A1,
                                 last0=last0, interpret=True)
    got = rans_bnd_dec.decode_walk4v3_o1(*map(torch.from_numpy, args), T,
                                         shift, A, A1, last0)
    _same(want, got)
    syms = got[0].numpy()
    for b, d in enumerate(datas):
        isz = len(d) // 32
        dense = syms[:isz, 0, b * 32:(b + 1) * 32]
        assert np.array_equal(alphabet[dense].T.reshape(-1), d)


@pytest.fixture
def walks(monkeypatch):
    """Names of the plain walks the engine reaches, in call order."""
    calls = []
    for mod, name in ((rans_torch, "decode_o0_ref"),
                      (rans_torch, "decode_o1_ref"),
                      (rans_bnd_torch, "decode_bnd_o0_ref"),
                      (rans_bnd_torch, "decode_dense_o1_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


def _engine_datas(rng, wide):
    """Ragged streams with <32-byte tails: DNA-like, quality-like, a
    single symbol and (wide) uniform bytes."""
    datas = [rng.choice(DNA, int(rng.integers(400, 3000))).tobytes()
             for _ in range(3)]
    datas.append(_qual(rng, 2017).tobytes())
    datas.append(bytes([72]) * 1333)
    if wide:
        datas.append(rng.integers(0, 256, 5003).astype(np.uint8).tobytes())
    return datas


@pytest.mark.parametrize("wide", [False, True])
def test_engine_o0_boundary_equals_lut(wide, walks):
    datas = _engine_datas(np.random.default_rng(30 + wide), wide)
    pays = engine_cuda.encode_o0_batch(datas, CPU)
    szs = [len(d) for d in datas]
    lut = engine_cuda.decode_o0_batch(pays, szs, CPU)
    bnd = engine_cuda.decode_o0_batch(pays, szs, CPU, tables="boundary")
    assert lut == bnd == datas
    assert walks == ["decode_o0_ref", "decode_bnd_o0_ref"]


@pytest.mark.parametrize("wide", [False, True])
def test_engine_o1_boundary_equals_lut(wide, walks):
    """A shift group whose alphabet exceeds 64 symbols walks its s3 LUTs
    under tables="boundary" too."""
    datas = _engine_datas(np.random.default_rng(40 + wide), wide)
    pays = engine_cuda.encode_o1_batch(datas, CPU)
    szs = [len(d) for d in datas]
    groups = {engine_cuda.o1_prep(d)[2] for d in datas}
    lut = engine_cuda.decode_o1_batch(pays, szs, CPU)
    n_lut = len(walks)
    assert walks == ["decode_o1_ref"] * len(groups)
    bnd = engine_cuda.decode_o1_batch(pays, szs, CPU, tables="boundary")
    assert lut == bnd == datas
    got = walks[n_lut:]
    if wide:
        assert "decode_o1_ref" in got
    else:
        assert got == ["decode_dense_o1_ref"] * len(groups)
    with pytest.raises(ValueError):
        engine_cuda.decode_o1_batch(pays, szs, CPU, tables="s3")


def test_jax_layouts_round_trip_on_the_port():
    """The layout helpers of rans_bnd_dec invert JAX's expand4."""
    rng = np.random.default_rng(5)
    tab = rng.integers(0, 1 << 30, (8, 24)).astype(np.int32)
    cexp = np.ascontiguousarray(rpd.expand4(tab).transpose(1, 0, 2))
    assert np.array_equal(rans_bnd_dec._tables(torch.from_numpy(cexp)),
                          tab)
    v = rng.integers(0, 999, 8).astype(np.int32)
    vexp = rpd.expand4(v.reshape(-1, 1))[:, 0, :]
    assert np.array_equal(rans_bnd_dec._per_stream(torch.from_numpy(vexp)),
                          v)
    syms = torch.from_numpy(rng.integers(0, 256, (8, 5, 32)).astype(
        np.uint8))
    want = np.asarray(jnp.asarray(syms.numpy()).reshape(2, 4, 5, 32)
                      .transpose(2, 0, 1, 3).reshape(5, 2, 128))
    assert np.array_equal(rans_bnd_dec._syms4(syms).numpy(), want)
