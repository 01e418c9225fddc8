"""Pass 1's merge on the device (``fqz_device_encode.build_stream``,
``seq_device_encode.build_events``) against the numpy merge of
``tests/pass1_ref.py``, value and dtype, on the CPU.

Both merge the port's own contexts, so any parameters hold: the cases
set the fields of the picked parameters that the cells never reach
(duplicate flags, several parameter sets with selectors, sequence
conditioning reaching past a record) and the shapes the merge splits on
(empty and one-record jobs, zero-length records, class runs that open
lower or other, cross records, or pass 255 bases, both strands on and
off).  The card runs the same cases (marked ``card``)."""

import dataclasses

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch.ops import fqz_device_encode as port_fqz
from fqzcomp5_tpu_torch.ops import seq_device_encode as port_seq
from tests import pass1_ref

CPU = torch.device("cpu")


def _quals(rng, lens, width=30):
    total = int(np.sum(lens))
    return np.clip(np.cumsum(rng.integers(-2, 3, total)) % width + 3,
                   0, 255).astype(np.uint8)


def _picked(q, lens, seq=None, strat=1):
    _, P, sels = port_fqz.prepare_fqz(bytes(q), lens,
                                      np.zeros(len(lens), np.uint32), seq,
                                      strat)
    return P, sels


def _widened(P, nparam, **fields):
    """P with its one parameter set repeated nparam times, then fields
    (gflags, stab, per-set arrays) set."""
    per = {f.name: np.repeat(getattr(P, f.name), nparam, axis=0)
           for f in dataclasses.fields(P)
           if isinstance(getattr(P, f.name), np.ndarray)
           and f.name != "stab"}
    return dataclasses.replace(P, nparam=nparam, **per, **fields)


def _fqz_fixed(rng):
    lens = np.full(70, 100, np.uint32)
    q = _quals(rng, lens)
    P, sels = _picked(q, lens, strat=0)
    return q, lens, sels, P, None


def _fqz_ragged(rng):
    lens = rng.integers(1, 160, 90).astype(np.uint32)
    q = _quals(rng, lens)
    P, sels = _picked(q, lens)
    return q, lens, sels, P, None


def _fqz_dedup(rng):
    """Duplicate neighbours, equal-length neighbours that differ in one
    byte, a shared prefix of another length, two empty records."""
    lens = np.array([50, 50, 50, 50, 40, 50, 0, 0, 50, 50, 7], np.uint32)
    recs = [_quals(rng, [m]) for m in lens]
    recs[1] = recs[0].copy()
    recs[2] = recs[1].copy()
    recs[3] = recs[2].copy()
    recs[3][-1] ^= 1
    recs[4] = recs[3][:40].copy()
    recs[9] = recs[8].copy()
    q = np.concatenate(recs)
    P, sels = _picked(q, lens)
    P = dataclasses.replace(P, do_dedup=np.ones_like(P.do_dedup))
    assert pass1_ref.dup_flags(q, lens).tolist() == [
        False, True, True, False, False, False, False, True, False, True,
        False]
    return q, lens, sels, P, None


def _fqz_multi(rng):
    """Three selectors over two parameter sets through the selector
    table: they differ in context, shift, selector and length events and
    duplicate flags."""
    lens = rng.integers(30, 60, 80).astype(np.uint32)
    lens[40:50] = 45
    q = _quals(rng, lens)
    P, _ = _picked(q, lens)
    stab = np.zeros(256, np.uint32)
    stab[1:3] = 1
    P = _widened(P, 2, gflags=port_fqz.K_G_MULTI_PARAM
                 | port_fqz.K_G_HAVE_STAB, max_sel=2, stab=stab)
    P.context[1] = P.context[0] + 17
    P.qshift[1] = max(int(P.qshift[0]) - 1, 1)
    P.do_sel[:] = [0, 1]
    P.fixed_len[:] = [1, 0]
    P.do_dedup[:] = [0, 1]
    sels = rng.integers(0, 3, len(lens)).astype(np.uint32)
    return q, lens, sels, P, None


def _fqz_multi_nostab(rng):
    lens = np.full(60, 40, np.uint32)
    q = _quals(rng, lens)
    P, _ = _picked(q, lens)
    P = _widened(P, 2, gflags=port_fqz.K_G_MULTI_PARAM, max_sel=1)
    P.fixed_len[:] = [1, 1]
    sels = rng.integers(0, 2, len(lens)).astype(np.uint32)
    return q, lens, sels, P, None


def _fqz_seq(rng):
    """Sequence-conditioned contexts whose offset passes some records'
    length (they seed from the next record's bases)."""
    lens = rng.integers(1, 14, 70).astype(np.uint32)
    q = _quals(rng, lens)
    seq = bytes(rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8),
                           int(lens.sum())))
    P, sels = _picked(q, lens, seq)
    P = dataclasses.replace(P, bbits=np.full_like(P.bbits, 4),
                            bloc=np.full_like(P.bloc, 9),
                            boff=np.full_like(P.boff, 6))
    return q, lens, sels, P, seq


def _fqz_one(rng):
    lens = np.array([77], np.uint32)
    q = _quals(rng, lens)
    P, sels = _picked(q, lens)
    return q, lens, sels, P, None


def _fqz_empty(rng):
    P, _ = _picked(_quals(rng, [20]), np.array([20], np.uint32))
    return (np.zeros(0, np.uint8), np.zeros(0, np.uint32),
            np.zeros(0, np.uint32), P, None)


def _seq_bytes(rng, n, alphabet=b"ACGTNacgt"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), n)


def _seq_lower_open(rng):
    s = _seq_bytes(rng, 900, b"ACGT")
    s[:30] = np.frombuffer(b"acgt" * 8, np.uint8)[:30]
    return s, np.array([300, 300, 300], np.uint32)


def _seq_n_open(rng):
    s = _seq_bytes(rng, 500, b"ACGT")
    s[:3] = ord("N")
    s[100:104] = ord("N")
    return s, np.array([120, 380], np.uint32)


def _seq_runs_cross(rng):
    """Short runs of every class, across the records' ends."""
    s = _seq_bytes(rng, 2000)
    cuts = np.unique(rng.integers(1, 2000, 40))
    return s, np.diff(np.concatenate(([0], cuts, [2000]))).astype(np.uint32)


def _seq_long_runs(rng):
    """Runs of 600, 510 (two whole chunks) and 255 bases, one of lower
    case: chunked run lengths."""
    s = np.concatenate([_seq_bytes(rng, 600, b"ACGT"), [ord("N")],
                        _seq_bytes(rng, 510, b"acgt"), [ord("N")] * 3,
                        _seq_bytes(rng, 255, b"ACGT")]).astype(np.uint8)
    return s, np.array([1000, len(s) - 1000], np.uint32)


def _seq_empty(rng):
    return np.zeros(0, np.uint8), np.zeros(0, np.uint32)


FQZ_CASES = {"fixed": _fqz_fixed, "ragged": _fqz_ragged,
             "dedup": _fqz_dedup, "multi_stab": _fqz_multi,
             "multi": _fqz_multi_nostab, "seq_boff": _fqz_seq,
             "one_record": _fqz_one, "empty": _fqz_empty}
SEQ_CASES = {"lower_open": _seq_lower_open, "n_open": _seq_n_open,
             "runs_cross": _seq_runs_cross, "long_runs": _seq_long_runs,
             "empty": _seq_empty}
CASES = ([("fqz", k, None) for k in FQZ_CASES]
         + [("seq", k, both) for k in SEQ_CASES for both in (0, 1)])


def _check(codec, case, both, device):
    rng = np.random.default_rng(sum(map(ord, case)) + (both or 0))
    if codec == "fqz":
        q, lens, sels, P, seq = FQZ_CASES[case](rng)
        mids, syms, n_over = port_fqz.build_stream(bytes(q), lens, sels, P,
                                                   device, seq=seq)
        want = pass1_ref.build_stream(bytes(q), lens, sels, P, device,
                                      seq=seq)
        got = (mids, syms)
        assert n_over == want[2]
        want = want[:2]
    else:
        s, lens = SEQ_CASES[case](rng)
        *got, n_upd = port_seq.build_events(s.tobytes(), lens, both, 12,
                                            device)
        want = pass1_ref.build_events(s.tobytes(), lens, both, 12, device)
        assert n_upd == int(want[3].sum())
    for a, b in zip(got, want, strict=True):
        assert a.device.type == device.type
        a = a.cpu().numpy()
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


IDS = [f"{c}-{k}" + ("" if b is None else f"-both{b}") for c, k, b in CASES]


@pytest.mark.parametrize("codec,case,both", CASES, ids=IDS)
def test_device_merge_matches_numpy_merge(codec, case, both):
    _check(codec, case, both, CPU)


@pytest.mark.card
@pytest.mark.parametrize("codec,case,both", CASES, ids=IDS)
def test_device_merge_on_the_card(codec, case, both):
    """The same cases with the merge on the card (this file imports no
    JAX: ``python -m pytest --noconftest -p no:cacheprovider -m card
    tests/test_torch_pass1.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check(codec, case, both, torch.device("cuda"))
