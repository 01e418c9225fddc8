"""The redesigned order-0 boundary decode walk as numpy mirrors, held on the
CPU against the plain walk and the JAX package, at zero tolerance
(integer coding).

csrc/rans_decode_bnd.cu's decode_bnd_o0 builds, on the card, one entry a
slot from a stream's boundary entries (the selected entry's F, and
(m - C) << 8 | sym) and walks it with no search;
rans_bnd_torch.bnd_o0_slot_table / decode_bnd_o0_compact mirror that
table and walk.  The kernel does not run here; chip_smoke.py holds it on
the card against the same plain walk on these cases
(torch_cases.bnd_o0_case, BND_O0_CASES, bnd_o0_variants).
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import rans_pallas_dec as rpd
from fqzcomp5_tpu_torch.ops import rans_bnd_dec, rans_bnd_torch
from tests import torch_cases
from tests.test_torch_bnd_decode import _four_args, _o0_case

T_STEPS = torch_cases.EDGE_T


def _case(shift, S, packed):
    rng = np.random.default_rng(1000 * shift + S + packed)
    return rng, torch_cases.bnd_o0_case(rng, S, shift, packed)


def _both(words, R0, tab, f0, t_real, S, packed, shift, T=T_STEPS):
    """The mirror against decode_bnd_o0_ref: equal symbols, states and
    word counts.  Returns the mirror's results."""
    t = torch.from_numpy
    want = rans_bnd_torch.decode_bnd_o0_ref(
        *(t(np.ascontiguousarray(a)) for a in (words, R0, tab, f0, t_real)),
        T, S, packed=packed, shift=shift)
    got = rans_bnd_torch.decode_bnd_o0_compact(
        words, R0, tab, f0, t_real, T, S, packed=packed, shift=shift)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1].view(np.int32), want[1].numpy())
    assert np.array_equal(got[2], want[2].numpy())
    return got


@pytest.mark.parametrize("shift,S,packed", torch_cases.BND_O0_CASES)
def test_bnd_o0_compact_walk_equals_plain(shift, S, packed):
    """Round trips (a single-symbol stream among them, f0 = tot), ragged
    lengths with a 0 (the rows past t_real hold 0), word rows cut short."""
    _, (words, R0, tab, f0, plane, _) = _case(shift, S, packed)
    assert f0[1] == 1 << shift and f0[2] == 0
    full = np.full(4, T_STEPS, np.int32)
    got = _both(words, R0, tab, f0, full, S, packed, shift)
    assert np.array_equal(got[0], plane)
    ragged = np.array([T_STEPS, 17, 0, T_STEPS - 1], np.int32)
    got = _both(words, R0, tab, f0, ragged, S, packed, shift)
    assert not got[0][1, 17:].any() and not got[0][2].any()
    assert got[2][2] == 0
    _both(words[:, :max(1, words.shape[1] // 4)], R0, tab, f0, full, S,
          packed, shift)


@pytest.mark.parametrize("variant", torch_cases.BND_O0_VARIANTS)
@pytest.mark.parametrize("shift,S,packed", torch_cases.BND_O0_CASES)
def test_bnd_o0_slot_table_edge_tables(shift, S, packed, variant):
    """Tables no encoder makes (rows below tot, boundaries out of order,
    inconsistent F fields, random entries, f0 = 0 and tot): every slot's
    (sym, F, m - C) is select_entry's at that slot, and the compact walk
    equals the plain walk."""
    rng, (words, R0, tab, f0, _, freqs) = _case(shift, S, packed)
    vs = dict((k, v) for k, *v in torch_cases.bnd_o0_variants(
        rng, freqs, tab, S, shift, packed))
    assert list(vs) == list(torch_cases.BND_O0_VARIANTS)
    tab, f0 = vs[variant]
    tot = 1 << shift
    m = torch.arange(tot).view(1, tot)
    E = rans_bnd_torch.u32(torch.from_numpy(np.ascontiguousarray(tab)))
    base = rans_bnd_torch.u32(torch.from_numpy(f0)) << (13 if packed else 14)
    for b in range(len(tab)):
        sym, F, C = rans_bnd_torch.select_entry(
            E[b].view(1, 1, S).expand(1, tot, S),
            base[b].view(1, 1).expand(1, tot), m,
            torch.ones((1, tot), dtype=torch.bool), packed)
        got = rans_bnd_torch.bnd_o0_slot_table(tab[b], f0[b], S, packed,
                                               shift)
        assert np.array_equal(got[0], (sym[0] & 0xFF).numpy())
        assert np.array_equal(got[1], F[0].numpy())
        assert np.array_equal(got[2], (m - C)[0].numpy())
    _both(words, R0, tab, f0, np.full(4, T_STEPS, np.int32), S, packed,
          shift)


def test_bnd_o0_slot_table_counts_out_of_order():
    """The counter form's symbol is the count of boundaries at most m,
    not the selected entry's index, where the boundaries do not rise."""
    tab = np.array([100 << 14 | 40, 7 << 14 | 10, 9 << 14 | 30,
                    1 << 14 | 4096], np.int32)
    sym, F, bias = rans_bnd_torch.bnd_o0_slot_table(tab, 5, 4, False, 12)
    m = np.arange(4096)
    assert np.array_equal(sym, (m >= 10).astype(int) + (m >= 30)
                          + (m >= 40))
    # entry 0 (boundary 40) is never selected: entry 2, later in the
    # row, qualifies from 30 on
    sel = np.where(m >= 30, 2, np.where(m >= 10, 1, -1))
    assert np.array_equal(F, np.where(sel == 2, 9, np.where(sel == 1, 7, 5)))
    assert np.array_equal(bias, m - np.where(sel == 2, 30,
                                             np.where(sel == 1, 10, 0)))


def _compact(words128):
    return rans_bnd_dec._words(torch.from_numpy(words128)).numpy()


def test_bnd_o0_compact_equals_jax_v1():
    """The Pallas decode_walk (v1, interpret mode) against the mirror on
    the counter tables build_dec_tables makes: symbols, states and the
    word cursor (Rf's lane 32)."""
    S = 256
    datas, words128, freqs, R0, treal = _o0_case(f"s{S}", 30 + S)
    R0_128 = np.zeros((len(datas), 128), np.int32)
    R0_128[:, :32] = R0
    tab = rpd.build_dec_tables(freqs, 12, S)
    f0 = freqs[:, 0].astype(np.int32)
    T = int(treal.max())
    want = rpd.decode_walk(words128, tab, f0.reshape(-1, 1), R0_128, treal,
                           T=T, shift=12, S=S, interpret=True)
    got = rans_bnd_torch.decode_bnd_o0_compact(
        _compact(words128), R0, tab, f0, treal, T, S, packed=False, shift=12)
    syms = np.asarray(want[0])[:, :, :32].transpose(1, 0, 2)
    assert np.array_equal(syms, got[0])
    Rf = np.asarray(want[1])
    assert np.array_equal(Rf[:, :32], got[1].view(np.int32))
    assert np.array_equal(Rf[:, 32], got[2])
    for b, d in enumerate(datas):
        t = len(d) // 32
        assert got[0][b, :t].tobytes() == d[:t * 32]


@pytest.mark.parametrize("S", [16, 64, 256])
def test_bnd_o0_compact_equals_jax_v3(S):
    """The Pallas decode_walk4v3 (interpret mode) against the mirror on the
    tables its route builds: packed (build_dec_tables_p) at S = 16 and 64,
    the counter form at 256; ragged lengths, a single-symbol stream."""
    datas, words128, freqs, R0, treal = _o0_case(f"s{S}", 40 + S)
    packed = S <= 64
    tab = (rpd.build_dec_tables_p if packed
           else rpd.build_dec_tables)(freqs, 12, S)
    args = _four_args(words128, tab, freqs, R0, treal)
    T = int(treal.max())
    want = rpd.decode_walk4v3(*args, T=T, shift=12, S=S, interpret=True)
    f0 = freqs[:, 0].astype(np.int32)
    got = rans_bnd_torch.decode_bnd_o0_compact(
        _compact(words128), R0, tab, f0, treal, T, S, packed=packed,
        shift=12)
    B = len(datas)
    syms = np.asarray(want[0]).reshape(T, B, 32).transpose(1, 0, 2)
    assert np.array_equal(syms, got[0])
    assert np.array_equal(np.asarray(want[1]).reshape(B, 32),
                          got[1].view(np.int32))
    for b, d in enumerate(datas):
        t = len(d) // 32
        assert got[0][b, :t].tobytes() == d[:t * 32]
