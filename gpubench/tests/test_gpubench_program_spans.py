"""The program's span log placed on the profiler's clock
(gbench.program_spans), on a synthetic profile reduction and a synthetic
log: the alignment picks the window's roots among warm-up and tally
ones, idle time goes to the innermost span, the shares and the unnamed
rest add up to device_idle_pct, a log that disagrees beyond 2 ms reads
nothing, a stall of the host outside one root is matched, and
candidate_bytes_per_byte counts only the window's encodes."""

import collections

import pytest

from gbench import program_spans, tracing
from gbench.registry import HERE, reader

Span = collections.namedtuple(
    "Span", "request id parent thread name t0_ns t1_ns counts")
T0 = 1_792_296_248_812_406_478     # the profiler's trace start, epoch ns
MAIN = 11
LAYERS = ("idle_parse_pct.encode", "idle_driver_pct.encode",
          "idle_prep_pct.encode", "idle_adaptive_pct.encode")

# one round trip, us from its start: (name, start, end) of the encode's
# spans below its root, of each decode's, and the card's busy intervals
ENC = [("parse/batch", 100, 1100), ("driver/wave", 1200, 9000),
       ("driver/start", 1300, 4000), ("prep/o1", 1400, 3000),
       ("link/put", 2000, 2200), ("kernel/encode_walk", 2400, 2600),
       ("adaptive/rc", 4100, 5000), ("driver/frame", 6000, 8000)]
DEC = [("decode/split", 100, 600), ("prep/dec_tables", 700, 1500),
       ("decode/host_blocks", 2000, 3800), ("decode/write", 3000, 3500)]
BUSY_ENC = [(1900, 2100), (2550, 2900), (4500, 4600)]
BUSY_DEC = [(1400, 1600)]
ENC_LEN, DEC_LEN, GAP = 10_000, 4_000, 500


class Log:
    """A synthetic program log on the epoch clock; profiler time p us is
    epoch ns T0 + 1000 p (its offset, plus lat us of host latency)."""

    def __init__(self, lat=50.0):
        self.records, self.lat, self.next_id = [], lat, 1

    def request(self, name, start, length, children, counts=None,
                stretch=0.0, late=0.0):
        rid = self.next_id
        self.next_id += len(children) + 1

        def ns(us):
            return int(T0 + 1000 * (start + us + self.lat))
        root = Span(rid, rid, None, MAIN, name, ns(late),
                    ns(length - 2 * self.lat + stretch), counts or {})
        for k, (child, a, b) in enumerate(children):
            self.records.append(Span(rid, rid + 1 + k, rid, MAIN, child,
                                     ns(a), ns(b), None))
        # a pool thread's span of the same request: never the innermost
        # one of the root's thread
        self.records.append(Span(rid, 10 ** 9 + rid, rid, MAIN + 1,
                                 "decode/block", ns(0), ns(length / 2),
                                 None))
        self.records.append(root)

    def round_trip(self, start, counts, stretch=0.0, late=0.0):
        self.request("encode", start, ENC_LEN, ENC, counts, stretch, late)
        for d in range(2):
            self.request("decode",
                         start + ENC_LEN + GAP + d * (DEC_LEN + GAP),
                         DEC_LEN, DEC)


class Trace:
    """What run.py's Trace gives the readers, for a window of round trips
    starting at the given profiler times."""

    def __init__(self, starts, in_bytes=1000):
        self.spans, busy = [], []
        for s in starts:
            self.spans.append(("encode", s, s + ENC_LEN))
            busy += [(s + a, s + b) for a, b in BUSY_ENC]
            for d in range(2):
                ds = s + ENC_LEN + GAP + d * (DEC_LEN + GAP)
                self.spans.append(("decode", ds, ds + DEC_LEN))
                busy += [(ds + a, ds + b) for a, b in BUSY_DEC]
        self.merged = tracing.merge(busy)
        Trip = collections.namedtuple("Trip", "in_bytes")
        self.trips = [Trip(in_bytes) for _ in starts]

    def spans_of(self, kind):
        return [(a, b) for name, a, b in self.spans if name == kind]


WINDOW = [0.0, 20_000.0]


def make_log():
    log = Log()
    # warm-up: the same durations, but 27 ms before the window (a period
    # is 20 ms), and before the profiler started
    log.round_trip(-27_000, {"candidate_bytes": 10 ** 6})
    for s in WINDOW:
        log.round_trip(s, {"candidate_bytes": 3000})
    # the tally round trip after the window
    log.round_trip(45_000, {"candidate_bytes": 10 ** 6})
    return log.records


@pytest.fixture
def program(monkeypatch):
    def use(records):
        monkeypatch.setattr(program_spans, "program_log", lambda: records)
    return use


def read(name, trace):
    return reader(HERE + "/metrics", name)(trace)


def test_alignment_picks_the_window(program):
    records = make_log()
    program(records)
    w = program_spans.window(Trace(WINDOW))
    assert w is not None
    roots = [r for r in records if r.parent is None]
    # roots: warm-up 3, window 6, tally 3, in that order
    assert [r.id for _, _, _, r in w.pairs] == [r.id for r in roots[3:9]]
    assert w.offset == pytest.approx(50 - T0 / 1e3, abs=1.0)


def test_idle_goes_to_the_innermost_span(program):
    program(make_log())
    tr = Trace(WINDOW)
    wall, idle = program_spans.window(tr).idle_us(tr.merged, "encode")
    assert wall == 2 * ENC_LEN
    # one round trip's encode, from ENC and BUSY_ENC: the offset puts
    # the root's end on its benchmark span's end, so the root and its
    # spans lie 100 us later than ENC (its first 100 us are no span's)
    want = {"encode": 100 + 100 + 100 + 900, "parse/batch": 1000,
            "driver/wave": 100 + 100 + 1000 + 1000,
            "driver/start": 100 + 1000, "prep/o1": 400 + 200 + 200,
            "link/put": 200, "kernel/encode_walk": 50,
            "adaptive/rc": 300 + 500, "driver/frame": 2000}
    assert idle == pytest.approx({k: 2 * v for k, v in want.items()},
                                 abs=2.0)
    assert sum(idle.values()) == pytest.approx(
        wall - sum(tracing.busy_in(tr.merged, a, b)
                   for k, a, b in tr.spans if k == "encode"))


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_shares_and_the_rest_add_up_to_device_idle(program, kind):
    program(make_log())
    tr = Trace(WINDOW)
    named = ({"idle_parse_pct.encode": "parse/",
              "idle_driver_pct.encode": "driver/",
              "idle_prep_pct.encode": "prep/",
              "idle_adaptive_pct.encode": "adaptive/"}
             if kind == "encode" else
             {"idle_host_decode_pct.decode": "decode/"})
    shares = {m: read(m, tr) for m in named}
    assert all(v is not None and v > 0 for v in shares.values())
    wall, idle = program_spans.window(tr).idle_us(tr.merged, kind)
    assert "decode/block" not in idle      # a pool thread's span
    for m, prefix in named.items():
        assert shares[m] == pytest.approx(100 * sum(
            us for name, us in idle.items() if name.startswith(prefix))
            / wall)
    # link/, kernel/, the other layers' and the root's own (unnamed)
    rest = 100 * sum(us for name, us in idle.items()
                     if not name.startswith(tuple(named.values()))) / wall
    assert rest > 0
    assert sum(shares.values()) + rest == pytest.approx(
        read(f"device_idle_pct.{kind}", tr))


@pytest.mark.parametrize("shift,stretch,late", [
    (2500.0, 0.0, 0.0), (0.0, 2500.0, 0.0), (0.0, 0.0, 2500.0)])
def test_a_log_beyond_2_ms_reads_nothing(program, shift, stretch, late):
    """The window's second round trip lies 2.5 ms later in the log than
    in the profile (the offsets disagree), or its encode lasts 2.5 ms
    longer than its benchmark span, or its three requests each 2.5 ms
    shorter (half of the window's: more than a quarter)."""
    log = Log()
    log.round_trip(-27_000, {})
    log.round_trip(WINDOW[0], {"candidate_bytes": 3000})
    start = WINDOW[1] + shift
    log.request("encode", start, ENC_LEN, ENC, {"candidate_bytes": 3000},
                stretch, late)
    for d in range(2):
        log.request("decode", start + ENC_LEN + GAP + d * (DEC_LEN + GAP),
                    DEC_LEN, DEC, late=late)
    program(log.records)
    tr = Trace(WINDOW)
    assert program_spans.window(tr) is None
    for m in LAYERS + ("idle_host_decode_pct.decode",
                       "candidate_bytes_per_byte.encode"):
        assert read(m, tr) is None


@pytest.mark.parametrize("side,at", [("start", 3), ("end", 5)])
def test_a_stall_outside_one_root_is_matched(program, side, at):
    """The host stands still for 2.5 ms inside one benchmark span but
    outside its root: before the second encode's root opens, or after
    the last decode's closes.  Matched as without it, with the same
    offset, and the stall, device-idle and under no span, goes to the
    root's own name."""
    starts = [0.0, 25_000.0]       # 6 ms between the round trips
    log = Log()
    for s in [-27_000.0] + starts + [50_000.0]:
        log.round_trip(s, {"candidate_bytes": 3000})
    program(log.records)
    plain = Trace(starts)
    tr = Trace(starts)
    name, a, b = tr.spans[at]
    tr.spans[at] = ((name, a - 2500.0, b) if side == "start"
                    else (name, a, b + 2500.0))
    w0 = program_spans.window(plain)
    w = program_spans.window(tr)
    assert w is not None
    assert [r.id for *_, r in w.pairs] == [r.id for *_, r in w0.pairs]
    assert w.offset == w0.offset
    _, idle0 = w0.idle_us(plain.merged, name)
    _, idle = w.idle_us(tr.merged, name)
    assert idle == pytest.approx(
        {**idle0, name: idle0[name] + 2500.0}, abs=1e-6)


def test_the_profiles_first_range_may_start_early(program):
    """The profiler's first range, the window's first encode, starts 5 ms
    before its root does: matched, those 5 ms the root's own."""
    log = Log()
    log.round_trip(-27_000, {})
    log.round_trip(WINDOW[0], {"candidate_bytes": 3000}, late=5000.0)
    log.round_trip(WINDOW[1], {"candidate_bytes": 3000})
    program(log.records)
    tr = Trace(WINDOW)
    assert program_spans.window(tr) is not None
    assert read("idle_parse_pct.encode", tr) > 0


def test_no_log_and_a_lost_window_read_nothing(program):
    program(None)                          # a program that keeps no spans
    assert read("idle_parse_pct.encode", Trace(WINDOW)) is None
    records = make_log()
    first = next(r for r in records if r.parent is None and r.t0_ns > T0)
    # the bounded log dropped everything closed before the window began
    program([r for r in records if r.t1_ns >= first.t0_ns])
    assert read("idle_parse_pct.encode", Trace(WINDOW)) is None


def test_candidate_bytes_count_only_the_window(program):
    program(make_log())
    tr = Trace(WINDOW, in_bytes=1000)
    assert read("candidate_bytes_per_byte.encode", tr) == pytest.approx(
        2 * 3000 / 2000)
