"""The redesigned dense order-1 decode walk and the staged order-0 walk,
as numpy mirrors, held on the CPU against the plain walks and the JAX
package, at zero tolerance (integer coding).

csrc/rans_decode_bnd.cu's decode_dense_o1 builds compact tables on the
card from the dense rows (a u8 slot code per context and slot, a
32-bit F, C word per context and entry) and walks them with no search;
rans_bnd_torch.dense_compact_tables / decode_dense_compact mirror that
form and walk.  csrc/rans_decode.cu's decode_o0 walks its s3 LUT from
shared memory and writes the rows past t_real from each lane's frozen
state; rans_torch.decode_o0_staged mirrors it.  Neither kernel runs
here; chip_smoke.py holds the kernels on the card against the same
plain walks on these cases.
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import rans_pallas_dec as rpd
from fqzcomp5_tpu_torch.ops import rans_bnd_torch, rans_torch
from tests import torch_cases
from tests.test_torch_bnd_decode import _words128

T_STEPS = torch_cases.EDGE_T


def _dense_case(rng, A, shift, zero, B=3, T=T_STEPS):
    return torch_cases.dense_case(rng, A, shift, zero, B=B, T=T)


def _both(words, R0, tab, t_real, shift, A, A1, last0, T=T_STEPS):
    """The mirror against decode_dense_o1_ref: equal symbols, states and
    word counts.  Returns the mirror's results."""
    t = torch.from_numpy
    want = rans_bnd_torch.decode_dense_o1_ref(
        *(t(np.ascontiguousarray(a)) for a in (words, R0, tab, t_real)), T,
        shift, A, A1, last0)
    got = rans_bnd_torch.decode_dense_compact(words, R0, tab, t_real, T,
                                              shift, A, A1, last0)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1].view(np.int32), want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())
    return got


@pytest.mark.parametrize("shift,A,zero,route", torch_cases.DENSE_CASES)
def test_dense_compact_walk_equals_plain(shift, A, zero, route):
    rng = np.random.default_rng(1000 * shift + A)
    words, R0, tab, A1, last0, sym, _ = _dense_case(rng, A, shift, zero)
    assert rans_bnd_torch.dense_route(A, shift) == route
    full = np.full(3, T_STEPS, np.int32)
    got = _both(words, R0, tab, full, shift, A, A1, last0)
    assert np.array_equal(got[0], sym)
    # ragged lengths (one empty stream) and a word row cut short, so
    # that lanes read past its end
    ragged = np.array([T_STEPS, 17, 0], np.int32)
    _both(words, R0, tab, ragged, shift, A, A1, last0)
    _both(words[:, :max(1, words.shape[1] // 4)], R0, tab, full, shift, A,
          A1, last0)


def test_dense_compact_tables_rows():
    """The slot codes are the count of a row's boundaries at most m, the
    words each entry's F and C; a context with no row (row A when byte 0
    is an own symbol) is all zero; a context that never occurs (a zero
    row) selects entry A at every slot."""
    rng = np.random.default_rng(5)
    words, R0, tab, A1, last0, _, freqs = _dense_case(rng, 7, 10, True)
    assert A1 == 7
    slot, wt = rans_bnd_torch.dense_compact_tables(tab[0], 7, A1, 10)
    E = tab[0].view(np.uint32).reshape(A1, 8).astype(np.int64)
    bnd = E[:, 1:] & 0x1FFF
    m = np.arange(1024)
    assert np.array_equal(slot[:A1], (bnd[:, None, :] <= m[None, :, None])
                          .sum(-1))
    assert np.array_equal(wt[:A1] >> 14, (E >> 13) & 0x1FFF)
    assert np.array_equal(wt[:A1] & 0x3FFF, E & 0x1FFF)
    assert not slot[7].any() and not wt[7].any()
    alpha = rans_bnd_torch.build_o1_dense_tables(freqs, 10)[1]
    freqs[:, alpha[3]] = 0
    zero, alpha2 = rans_bnd_torch.build_o1_dense_tables(freqs, 10)[:2]
    assert np.array_equal(alpha, alpha2)
    slot, _ = rans_bnd_torch.dense_compact_tables(zero[0], 7, A1, 10)
    assert (slot[3] == 7).all()
    full = np.full(3, T_STEPS, np.int32)
    _both(words, R0, zero, full, 10, 7, A1, last0)


@pytest.mark.parametrize("shift,A,zero,route", torch_cases.DENSE_CASES)
def test_dense_boundaries_out_of_order(shift, A, zero, route):
    """Rows whose boundaries do not rise (torch_cases.scramble_boundaries):
    the slot runs still cover every slot once, each slot taking the last
    entry whose boundary is at most it (0 where none is), the entry the
    plain walk selects; in the packed form the compact walk then equals
    the plain walk on any such table."""
    rng = np.random.default_rng(1000 * shift + A)
    words, R0, tab, A1, last0, _, _ = _dense_case(rng, A, shift, zero)
    bad = torch_cases.scramble_boundaries(np.random.default_rng(A1), tab, A,
                                          A1)
    tot = 1 << shift
    E = bad.view(np.uint32).reshape(3, A1, A + 1).astype(np.int64)
    bnd = E[..., 1:] & (0x1FFF if A <= 64 else 0x3FFF)
    assert (np.diff(bnd, axis=-1) < 0).any(-1).sum() > A1
    m = np.arange(tot)
    for b in range(3):
        slot, _ = rans_bnd_torch.dense_compact_tables(bad[b], A, A1, shift)
        le = bnd[b][:, None, :] <= m[None, :, None]
        last = np.where(le.any(-1),
                        A - np.argmax(le[..., ::-1], axis=-1), 0)
        assert np.array_equal(slot[:A1], last)
    if A <= rans_bnd_torch.DENSE_MAX_A:
        _both(words, R0, bad, np.full(3, T_STEPS, np.int32), shift, A, A1,
              last0)


@pytest.mark.parametrize("shift,A,zero", [(10, 6, False), (12, 9, True)])
def test_dense_compact_walk_equals_jax(shift, A, zero):
    """Four streams in the JAX layout through the Pallas decode_walk4v3_o1
    (interpret mode), against the mirror: ragged lengths, one of them 0."""
    rng = np.random.default_rng(shift + A)
    B, T = 4, 24
    words, R0, tab, A1, last0, sym, _ = _dense_case(rng, A, shift, zero,
                                                    B=B, T=T)
    t_real = np.array([T, 11, 0, T], np.int32)
    want = rpd.decode_walk4v3_o1(
        _words128(words.view(np.uint16)),
        np.ascontiguousarray(rpd.expand4(tab).transpose(1, 0, 2)),
        R0.reshape(1, 128), rpd.expand4(t_real.reshape(-1, 1))[:, 0, :],
        T=T, shift=shift, A=A, A1=A1, last0=last0, interpret=True)
    got = _both(words, R0, tab, t_real, shift, A, A1, last0, T=T)
    syms4 = np.asarray(want[0]).reshape(T, B, 32).transpose(1, 0, 2)
    assert np.array_equal(syms4, got[0])
    assert np.array_equal(np.asarray(want[1]).reshape(B, 32),
                          got[1].view(np.int32))
    assert np.array_equal(np.asarray(want[2]).reshape(B, 32)[:, 0], got[2])
    assert np.array_equal(got[0][0], sym[0])


def test_dense_engine_tables_single_symbol_shift12():
    """Tables as the engine builds them, from frequencies recovered from
    s3 LUTs: a single-symbol context's f = 4096 wrapped to 0 there at
    shift 12, and the contexts that never occur give byte 0 at f = tot,
    so byte 0 joins the alphabet (A = 6, A1 = 6)."""
    rng = np.random.default_rng(12)
    words, R0, _, _, _, sym, freqs = _dense_case(rng, 5, 12, False)
    s3 = rans_torch.build_s3(freqs, 12).reshape(3, -1)
    assert (s3.reshape(3, 256, 4096)[0].max(-1) >> 20 == 0).sum() > 200
    tab, alpha, A, A1, last0 = rans_bnd_torch.build_o1_dense_tables(
        rans_bnd_torch.freqs_from_s3(s3, 12), 12)
    assert (A, A1, last0, alpha[0]) == (6, 6, 0, 0)
    full = np.full(3, T_STEPS, np.int32)
    got = _both(words, R0, tab, full, 12, A, A1, last0)
    assert np.array_equal(got[0], sym + 1)
    _both(words, R0, tab, np.array([3, T_STEPS, 0], np.int32), 12, A, A1,
          last0)


@pytest.mark.parametrize("cut", [False, True])
def test_o0_staged_walk_equals_plain(cut):
    """The staged order-0 walk against decode_o0_ref: ragged lengths
    (one 0), the rows past t_real (the frozen state's symbol), a
    single-symbol stream (its f = 4096 wrapped to 0 in s3) and, with cut,
    word rows cut short."""
    T = T_STEPS
    words, R0, s3, plane = torch_cases.o0_case(np.random.default_rng(7))
    assert (s3[1].view(np.uint32) >> 20 == 0).all()
    if cut:
        words = words[:, :max(1, words.shape[1] // 4)]
    t_real = np.array([T, 13, 0, T - 1], np.int32)
    t = torch.from_numpy
    want = rans_torch.decode_o0_ref(*(t(np.ascontiguousarray(a)) for a in
                                      (words, R0, s3, t_real)), T)
    got = rans_torch.decode_o0_staged(words, R0, s3, t_real, T)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1].view(np.int32), want[1].numpy())
    if not cut:
        assert np.array_equal(got[0][0], plane[0])
        assert np.array_equal(got[0][1, :13], plane[1, :13])
