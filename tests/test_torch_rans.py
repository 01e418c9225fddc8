"""The port's plain rANS walks and table builders against the JAX package.

Inputs come from numpy generators with fixed seeds and go through both
frameworks: the plain PyTorch versions (fqzcomp5_tpu_torch.ops.rans_torch,
reached through the kernel wrappers with CPU tensors) and the JAX scans
(rans_jax.encode_scan_flat / decode_scan / decode_scan_o1, which
tests/test_rans_pallas*.py hold bit-identical to the Pallas kernels).
All comparisons are exact: this is integer entropy coding.  The CUDA
kernels themselves are compared with the plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import rans_jax, rans_pallas
from fqzcomp5_tpu_torch import engine_cuda
from fqzcomp5_tpu_torch.ops import rans_cuda, rans_cuda_dec, rans_torch


def _norm_rows(counts: np.ndarray, shift: int) -> np.ndarray:
    """Rows of counts -> rows summing to 1<<shift, each counted symbol
    at least 1; zero rows stay zero."""
    tot = 1 << shift
    c = counts.astype(np.int64)
    rs = c.sum(-1, keepdims=True)
    k = (c > 0).sum(-1, keepdims=True)
    f = np.where(c > 0, 1 + (c * (tot - k)) // np.maximum(rs, 1), 0)
    fix = np.where(rs[..., 0] > 0, tot - f.sum(-1), 0)
    am = f.argmax(-1)[..., None]
    np.put_along_axis(f, am, np.take_along_axis(f, am, -1) + fix[..., None],
                      -1)
    return f.astype(np.uint32)


def _streams(seed: int, lens):
    rng = np.random.default_rng(seed)
    kinds = [lambda n: rng.choice(np.frombuffer(b"ACGT", np.uint8), n),
             lambda n: (np.cumsum(rng.integers(-2, 3, n)) % 40 + 35
                        ).astype(np.uint8),
             lambda n: rng.integers(0, 256, n).astype(np.uint8)]
    return [kinds[i % 3](n) for i, n in enumerate(lens)]


def _jax_tables(freqs, shift):
    """encode_scan_flat's per-stream tables with the no-op row appended
    (as fqzcomp5_tpu.ops.backend.encode_flat_lazy builds them)."""
    B = freqs.shape[0]
    out = []
    for a, v in zip(rans_jax.build_enc_tables(freqs, shift),
                    (0xFFFFFFFF, 0, 0, 0, 0)):
        out.append(np.concatenate([a.reshape(B, -1),
                                   np.full((B, 1), v, a.dtype)], axis=1))
    return out


def _jax_encode(flat, freqs, shift, R0=None):
    """(Rf (B,32) u32, [compact words per stream] u16) from the scan."""
    Rf, words, mask = rans_jax.encode_scan_flat(
        flat, *_jax_tables(freqs, shift), R0)
    Rf, words, mask = np.asarray(Rf), np.asarray(words), np.asarray(mask)
    rows = []
    for b in range(flat.shape[0]):
        blob = rans_jax.assemble_o0_stream(Rf[b], words[b], mask[b])
        rows.append(np.frombuffer(blob[128:], "<u2"))
    return Rf.astype(np.uint32), rows


def _port_rows(Rf, words, nwords):
    Rf = Rf.numpy().view(np.uint32)
    w = words.numpy().view(np.uint16)
    cap = w.shape[1]
    return Rf, [w[b, cap - int(n):] for b, n in enumerate(nwords.numpy())]


def _o0_inputs(lens, seed=1):
    datas = _streams(seed, lens)
    B = len(datas)
    T = max((n + 31) // 32 for n in lens)
    plane = np.zeros((B, T * 32), np.uint8)
    flat = np.full((B, T * 32), 256, np.int32)
    freqs = np.empty((B, 256), np.uint32)
    for b, d in enumerate(datas):
        plane[b, :len(d)] = d
        flat[b, :len(d)] = d
        freqs[b] = engine_cuda.o0_prep(d.tobytes())[1]
    return (datas, plane.reshape(B, T, 32), flat.reshape(B, T, 32), freqs,
            np.array(lens, np.int32))


def _o1_inputs(lens, shift, seed=2):
    datas = _streams(seed, lens)
    B = len(datas)
    iszs = [n // 32 for n in lens]
    T = max(iszs)
    flat = np.full((B, T, 32), 256 * 256, np.int32)
    counts = np.zeros((B, 256 * 256), np.int64)
    for b, d in enumerate(datas):
        isz = iszs[b]
        ch = d[:32 * isz].reshape(32, isz).T.astype(np.int32)
        flat[b, 0, :] = ch[0]
        flat[b, 1:isz] = ch[:-1] * 256 + ch[1:]
        counts[b] = np.bincount(flat[b, :isz].reshape(-1),
                                minlength=256 * 256)
    freqs = _norm_rows(counts.reshape(B, 256, 256), shift)
    return datas, flat, freqs, np.array(iszs, np.int32)


def test_encode_o0_plain_matches_scan():
    # ragged lengths: a full last row, a partial one, and pad rows
    datas, plane, flat, freqs, lens = _o0_inputs([3200, 2917, 1000, 4500])
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=12)
    got = _port_rows(*rans_cuda.encode_walk(
        torch.from_numpy(plane), tab, 12, nsym=torch.from_numpy(lens)))
    want = _jax_encode(flat, freqs, 12)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def test_encode_o0_u8_plane_equals_flat_plane():
    _, plane, flat, freqs, lens = _o0_inputs([2000, 777], seed=5)
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=12)
    a = rans_cuda.encode_walk(torch.from_numpy(plane), tab, 12,
                              nsym=torch.from_numpy(lens))
    b = rans_cuda.encode_walk(torch.from_numpy(flat), tab, 12)
    for x, y in zip(a[:1] + a[2:], b[:1] + b[2:]):
        assert torch.equal(x, y)
    assert all(np.array_equal(p, q) for p, q in
               zip(_port_rows(*a)[1], _port_rows(*b)[1]))


@pytest.mark.parametrize("shift", [10, 12])
def test_encode_o1_plain_matches_scan_with_seed(shift):
    datas, flat, freqs, iszs = _o1_inputs([6400, 5000, 3300], shift)
    rng = np.random.default_rng(shift)
    R0 = np.full((3, 32), rans_jax.RANS_L, np.uint32)
    R0[:, 31] = rng.integers(1 << 15, 1 << 31, 3)
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=shift)
    got = _port_rows(*rans_cuda.encode_walk(
        torch.from_numpy(flat), tab, shift,
        R0=torch.from_numpy(R0.view(np.int32))))
    want = _jax_encode(flat, freqs, shift, R0)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


def _decode_inputs(Rf, rows):
    B = len(rows)
    W = max(1, max(len(r) for r in rows))
    words = np.zeros((B, W), np.uint16)
    for b, r in enumerate(rows):
        words[b, :len(r)] = r
    return words, Rf


def test_decode_o0_plain_matches_scan():
    datas, plane, _, freqs, lens = _o0_inputs([3200, 2917, 1000, 4500])
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=12)
    Rf, rows = _port_rows(*rans_cuda.encode_walk(
        torch.from_numpy(plane), tab, 12, nsym=torch.from_numpy(lens)))
    words, R0 = _decode_inputs(Rf, rows)
    s3 = rans_torch.build_s3(freqs, 12)
    t_real = lens // 32
    T = int(t_real.max()) + 3   # steps past every stream's end
    syms, Rd = rans_cuda_dec.decode_o0(
        torch.from_numpy(words.view(np.int16)),
        torch.from_numpy(R0.view(np.int32)),
        rans_torch.tables_from_numpy(s3, "s3"), torch.from_numpy(t_real),
        T)
    js, jR, _ = rans_jax.decode_scan(
        words.astype(np.uint32), R0, s3, T, t_real=t_real)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Rd.numpy().view(np.uint32),
                                  np.asarray(jR))
    for b, d in enumerate(datas):
        t = lens[b] // 32
        np.testing.assert_array_equal(syms.numpy()[b, :t].reshape(-1),
                                      d[:t * 32])


@pytest.mark.parametrize("shift", [10, 12])
def test_decode_o1_plain_matches_scan(shift):
    datas, flat, freqs, iszs = _o1_inputs([6400, 5000, 3300], shift)
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=shift)
    Rf, rows = _port_rows(*rans_cuda.encode_walk(
        torch.from_numpy(flat), tab, shift))
    words, R0 = _decode_inputs(Rf, rows)
    s3 = rans_torch.build_s3(freqs, shift).reshape(3, -1)
    T = int(iszs.max()) + 2
    syms, Rd, ptr = rans_cuda_dec.decode_o1(
        torch.from_numpy(words.view(np.int16)),
        torch.from_numpy(R0.view(np.int32)),
        rans_torch.tables_from_numpy(s3, "s3"), torch.from_numpy(iszs), T,
        shift)
    js, jR, jp = rans_jax.decode_scan_o1(
        words.astype(np.uint32), R0, s3, T, shift, t_real=iszs)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Rd.numpy().view(np.uint32),
                                  np.asarray(jR))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ptr.numpy(), [len(r) for r in rows])
    for b, d in enumerate(datas):
        isz = iszs[b]
        np.testing.assert_array_equal(syms.numpy()[b, :isz].T.reshape(-1),
                                      d[:32 * isz])


def test_decode_single_symbol_stream():
    # f = 4096 << 20 wraps to 0 in the u32 LUT.  decode_scan takes it as
    # 0, renormalises every step and reads past the stream's end (its
    # symbols stay right); the port reads it as f = tot, so the states
    # walk back to the encoder's initial RANS_L and no word is read.
    d = np.full(3000, 71, np.uint8)
    freqs = engine_cuda.o0_prep(d.tobytes())[1][None]
    assert freqs.max() == 4096
    plane = np.zeros((1, 94 * 32), np.uint8)
    plane[0, :3000] = d
    tab = rans_torch.tables_from_numpy(freqs, "freqs", shift=12)
    Rf, rows = _port_rows(*rans_cuda.encode_walk(
        torch.from_numpy(plane.reshape(1, 94, 32)), tab, 12,
        nsym=torch.tensor([3000], dtype=torch.int32)))
    assert len(rows[0]) == 0
    words, R0 = _decode_inputs(Rf, rows)
    s3 = rans_torch.build_s3(freqs, 12)
    t_real = np.array([3000 // 32], np.int32)
    syms, Rd = rans_cuda_dec.decode_o0(
        torch.from_numpy(words.view(np.int16)),
        torch.from_numpy(R0.view(np.int32)),
        rans_torch.tables_from_numpy(s3, "s3"), torch.from_numpy(t_real),
        int(t_real[0]))
    js, _, _ = rans_jax.decode_scan(words.astype(np.uint32), R0, s3,
                                    int(t_real[0]), t_real=t_real)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(js))
    assert (syms.numpy() == 71).all()
    assert (Rd.numpy() == rans_torch.RANS_L).all()


def test_tables_from_numpy_round_trips():
    rng = np.random.default_rng(9)
    f0 = _norm_rows(rng.integers(0, 50, (3, 256)), 12)
    f1 = _norm_rows(rng.integers(0, 3, (2, 256, 256)), 10)
    for f, shift in ((f0, 12), (f1, 10)):
        want = rans_pallas.build_packed_tables(f, shift)
        got = rans_torch.tables_from_numpy(f, "freqs", shift=shift)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        again = rans_torch.tables_from_numpy(want, "packed")
        np.testing.assert_array_equal(again.numpy(), want)
    s3 = rans_jax.build_s3(f0, 12)
    t = rans_torch.tables_from_numpy(s3, "s3")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), s3)
    with pytest.raises(ValueError):
        rans_torch.tables_from_numpy(s3, "nope")


def test_copied_table_builders_equal_originals():
    rng = np.random.default_rng(11)
    f = _norm_rows(rng.integers(0, 9, (2, 3, 256)), 12)
    for a, b in zip(rans_torch.build_enc_tables(f, 12),
                    rans_jax.build_enc_tables(f, 12)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rans_torch.build_s3(f, 12),
                                  rans_jax.build_s3(f, 12))
    np.testing.assert_array_equal(
        rans_torch.build_packed_tables(f[:, 0], 12),
        rans_pallas.build_packed_tables(f[:, 0], 12))
    Rf = rng.integers(0, 1 << 31, 32).astype(np.uint32)
    w = rng.integers(0, 1 << 16, (5, 32)).astype(np.uint32)
    m = rng.random((5, 32)) < 0.3
    assert (rans_torch.assemble_o0_stream(Rf, w, m)
            == rans_jax.assemble_o0_stream(Rf, w, m))


def test_wrappers_take_plain_versions_on_cpu_only(monkeypatch):
    calls = []
    for name in ("encode_walk_ref", "decode_o0_ref", "decode_o1_ref"):
        fn = getattr(rans_torch, name)
        monkeypatch.setattr(
            rans_torch, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    before = (rans_cuda.encode_walk.launches,
              rans_cuda_dec.decode_o0.launches,
              rans_cuda_dec.decode_o1.launches)
    idx = torch.zeros((1, 2, 32), dtype=torch.int32)
    tab = rans_torch.tables_from_numpy(
        _norm_rows(np.ones((1, 256)), 12), "freqs")
    rans_cuda.encode_walk(idx, tab, 12)
    w = torch.zeros((1, 1), dtype=torch.int16)
    R0 = torch.full((1, 32), rans_torch.RANS_L, dtype=torch.int32)
    tr = torch.ones(1, dtype=torch.int32)
    rans_cuda_dec.decode_o0(w, R0, torch.zeros((1, 4096), dtype=torch.int32),
                            tr, 1)
    rans_cuda_dec.decode_o1(w, R0,
                            torch.zeros((1, 256 << 10), dtype=torch.int32),
                            tr, 1, 10)
    assert calls == ["encode_walk_ref", "decode_o0_ref", "decode_o1_ref"]
    assert before == (rans_cuda.encode_walk.launches,
                      rans_cuda_dec.decode_o0.launches,
                      rans_cuda_dec.decode_o1.launches)
    with pytest.raises(ValueError):
        rans_cuda.encode_walk(idx.to("meta"), tab.to("meta"), 12)
