"""The readers of rans_step_ns.encode and rans_step_ns.decode on a
hand-made trace: the rANS walks' kernels that started inside the
direction's spans count once where they overlap, other kernels, copies
and launches outside the window do not count, the steps are the
window's requests' walk_steps/ counters of the rANS walks only, and a
program that counts no steps, or a trace with no walk, reads None."""

import collections

import pytest

from gbench import program_spans
from gbench.registry import HERE, reader

Span = collections.namedtuple(
    "Span", "request id parent thread name t0_ns t1_ns counts")
T0 = 1_792_296_248_812_406_478     # the profiler's trace start, epoch ns
ENC_LEN, DEC_LEN, GAP = 10_000, 4_000, 500
STARTS = [0.0, 20_000.0]           # the window's round trips (us)
NS = "(anonymous namespace)::"

# per round trip, us from its encode's start: (kernel, start, end)
ENC_KERNELS = [
    (NS + "encode_o1_kernel(int const*, int const*, int, int)", 1000, 3000),
    (NS + "encode_o0_kernel(unsigned char const*, int const*)", 2000, 2500),
    ("void " + NS + "evolve_kernel<128>(unsigned char const*)", 3000, 9000),
    ("Memcpy HtoD (Pageable -> Device)", 500, 900)]
DEC_KERNELS = [
    (NS + "decode_o0_kernel(unsigned short const*, long long)", 100, 600),
    (NS + "decode_dense_o1_kernel(unsigned short const*, long long)",
     400, 1400),
    ("void " + NS + "decode_bnd_o0_kernel<true>(unsigned short const*)",
     2000, 2300),
    ("Memcpy DtoH (Device -> Pageable)", 2300, 3000)]
ENC_COUNTS = {"walk_steps/encode_walk": 1000, "walk_steps/evolve_128": 7,
              "walk_symbols/encode_walk": 32000}
DEC_COUNTS = {"walk_steps/decode_o0": 300, "walk_steps/decode_dense_o1": 300,
              "walk_steps/decode_bnd_o0": 200, "walk_steps/rc_encode_walk": 9}


class Trace:
    """What run.py's Trace gives the readers: the benchmark's spans and
    the device's events (us on the profiler's clock)."""

    def __init__(self, starts, enc=ENC_KERNELS, dec=DEC_KERNELS):
        self.spans, self.device = [], []
        for s in starts:
            d = s + ENC_LEN + GAP
            self.spans += [("encode", s, s + ENC_LEN),
                           ("decode", d, d + DEC_LEN)]
            self.device += [(k, s + a, s + b) for k, a, b in enc]
            self.device += [(k, d + a, d + b) for k, a, b in dec]

    def spans_of(self, kind):
        return [(a, b) for name, a, b in self.spans if name == kind]


def log(starts, enc_counts, dec_counts):
    """Roots of the warm-up, the window's round trips and the tally, each
    exactly over its benchmark span."""
    out = []
    for s in [-27_000.0, *starts, starts[-1] + 25_000.0]:
        d = s + ENC_LEN + GAP
        for name, a, b, counts in (("encode", s, s + ENC_LEN, enc_counts),
                                   ("decode", d, d + DEC_LEN, dec_counts)):
            rid = len(out) + 1
            out.append(Span(rid, rid, None, 1, name, int(T0 + 1000 * a),
                            int(T0 + 1000 * b), dict(counts)))
    return out


@pytest.fixture
def program(monkeypatch):
    def use(records):
        monkeypatch.setattr(program_spans, "program_log", lambda: records)
    return use


def read(name, trace):
    return reader(HERE + "/metrics", name)(trace)


def test_overlapping_walks_count_once(program):
    program(log(STARTS, ENC_COUNTS, DEC_COUNTS))
    tr = Trace(STARTS)
    # an encode walk of the warm-up, before the window, counts nothing
    tr.device.append((ENC_KERNELS[0][0], -26_000.0, -20_000.0))
    # encode: o1 [1000, 3000] and o0 [2000, 2500] are 2000 us together,
    # over 1000 steps, twice
    assert read("rans_step_ns.encode", tr) == pytest.approx(
        1e3 * 2 * 2000 / (2 * 1000))
    # decode: [100, 1400] and [2000, 2300], over 800 steps, twice
    assert read("rans_step_ns.decode", tr) == pytest.approx(
        1e3 * 2 * (1300 + 300) / (2 * 800))


def test_a_shorter_chain_and_a_faster_step_read_lower(program):
    program(log(STARTS, {**ENC_COUNTS, "walk_steps/encode_walk": 2000},
                DEC_COUNTS))
    tr = Trace(STARTS)
    assert read("rans_step_ns.encode", tr) == pytest.approx(1e3)
    # every walk twice as fast, from the first one's start
    fast = [(k, 1000 + (a - 1000) / 2, 1000 + (b - 1000) / 2)
            for k, a, b in ENC_KERNELS]
    assert read("rans_step_ns.encode", Trace(STARTS, enc=fast)) == (
        pytest.approx(5e2))


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_no_steps_or_no_walks_read_none(program, kind):
    # a program without the counters: its roots hold only walk_symbols
    program(log(STARTS, {"walk_symbols/encode_walk": 32000},
                {"walk_symbols/decode_o1": 32000}))
    assert read(f"rans_step_ns.{kind}", Trace(STARTS)) is None
    # the counters, but no rANS walk in the trace
    program(log(STARTS, ENC_COUNTS, DEC_COUNTS))
    assert read(f"rans_step_ns.{kind}", Trace(STARTS, enc=[], dec=[])) is None
    # no log at all
    program(None)
    assert read(f"rans_step_ns.{kind}", Trace(STARTS)) is None
