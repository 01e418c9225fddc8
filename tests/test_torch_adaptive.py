"""The port's adaptive-codec encode modules against the JAX package, on
the CPU (the plain versions the CUDA kernel wrappers take there).

Inputs come from numpy seeds; the tolerance is zero: this is integer
entropy coding.  Covered: pass-2 model evolution (128 and 256 slots,
TinyModel), the pass-3 range coder (carry runs, 0xFF runs across a chunk
boundary, ragged and empty streams, a JAX state continued by the port),
pass 1 and the parameter tables, whole batches of jobs, and the fqz
decline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqzcomp5_tpu.codecs import host
from fqzcomp5_tpu.ops import adaptive_batch as jax_batch
from fqzcomp5_tpu.ops import (fqz_ctx_jax, fqz_device_encode, fqz_model_jax,
                              model_pallas, rc_jax, rc_pallas,
                              seq_device_encode)
from fqzcomp5_tpu_torch.ops import adaptive_batch, fqz_ctx_torch
from fqzcomp5_tpu_torch.ops import fqz_device_encode as port_fqz
from fqzcomp5_tpu_torch.ops import fqz_model_torch, model_cuda, rc_cuda
from fqzcomp5_tpu_torch.ops import rc_torch
from fqzcomp5_tpu_torch.ops import seq_device_encode as port_seq
from fqzcomp5_tpu_torch.mesh import Mesh
from tests import pass2_ref

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unpack(cf, tot):
    cf = cf.numpy().view(np.uint32)
    return cf >> 16, cf & 0xFFFF, tot.numpy().view(np.uint32)


def _same_triples(got, want, counts):
    """Triples equal where counts say a step was walked; the port's
    planes are zero past the counts."""
    T = got[0].shape[1]
    m = np.arange(T)[None, :] < np.asarray(counts)[:, None]
    for g, w in zip(got, want):
        w = np.asarray(w)[:, :T]
        assert np.array_equal(g[m], w[m])
        assert not g[~m].any()


def _model_case(seed, C, T, max_sym):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, T + 1, C).astype(np.int32)
    counts[0] = T
    ms = rng.integers(2, max_sym + 1, C).astype(np.int32)
    ms[0] = max_sym
    z = rng.zipf(1.3, (C, T))
    sp = np.minimum(z - 1, ms[:, None] - 1).astype(np.int32)
    sp[1] = ms[1] - 1        # one symbol: max-rate bumps, no swap at 0
    return sp, counts, ms


# ---------------------------------------------------------------------
# pass 2: model evolution

@pytest.mark.parametrize("C,T,max_sym", [
    (9, 300, 96),      # bubble-heavy early phase, per-row alphabets
    (4, 4600, 64),     # crosses the first normalisation (~4095 steps)
    (3, 600, 4),       # tiny alphabet
])
def test_evolve_128_matches_jax_scan_and_pallas(C, T, max_sym):
    sp, counts, ms = _model_case(C * T, C, T, max_sym)
    got = _unpack(*model_cuda.evolve_128(_t(sp.astype(np.uint8)),
                                         _t(counts), _t(ms)))
    want = fqz_model_jax.evolve(jnp.asarray(sp), jnp.asarray(counts),
                                jnp.asarray(ms), jnp.int32(16), lanes=128)
    _same_triples(got, want, counts)
    if T > 600:
        return   # the interpreted Pallas walk is slow; short cases only
    Cp, Tp = model_pallas.C_BLK, -(-T // 128) * 128
    spp = np.zeros((Cp, Tp), np.int32)
    spp[:C, :T] = sp
    ctp = np.zeros((Cp, 1), np.int32)
    ctp[:C, 0] = counts
    msp = np.full((Cp, 1), 2, np.int32)
    msp[:C, 0] = ms
    pal = model_pallas.evolve_walk(jnp.asarray(spp), jnp.asarray(ctp),
                                   jnp.asarray(msp), 16, interpret=True)
    _same_triples(got, [np.asarray(x)[:C] for x in pal], counts)


def test_evolve_256_matches_jax_scan():
    """Full-byte alphabets past the first normalisation (~4080 steps)."""
    sp, counts, ms = _model_case(5, 5, 4600, 256)
    sp[2] = np.random.default_rng(6).integers(0, 256, 4600)
    ms[2] = 256
    got = _unpack(*model_cuda.evolve_256(_t(sp.astype(np.uint8)),
                                         _t(counts), _t(ms)))
    want = fqz_model_jax.evolve(jnp.asarray(sp), jnp.asarray(counts),
                                jnp.asarray(ms), jnp.int32(16), lanes=256)
    _same_triples(got, want, counts)


@pytest.mark.parametrize("nsym", [2, 4])
def test_tiny_evolve_matches_jax_scan(nsym):
    rng = np.random.default_rng(nsym)
    C, T = 7, 1500
    counts = rng.integers(1, T + 1, C).astype(np.int32)
    counts[0] = T
    sp = rng.integers(0, nsym, (C, T)).astype(np.int32)
    sp[1] = nsym - 1         # hot symbol: the 255 normalisation repeats
    got = _unpack(*model_cuda.tiny_evolve(_t(sp.astype(np.uint8)),
                                          _t(counts), nsym))
    want = fqz_model_jax.tiny_evolve(jnp.asarray(sp), jnp.asarray(counts),
                                     nsym=nsym)
    _same_triples(got, want, counts)


def test_group_stream_and_triples_for_stream_match_jax():
    rng = np.random.default_rng(11)
    n, ncx, max_sym = 6000, 37, 40
    ctx = rng.integers(0, ncx, n).astype(np.uint32) * 1000 + 5
    ctx[:400] = 5            # one hot context: a second count bucket
    qm = rng.integers(0, max_sym, n).astype(np.uint8)
    for a, b in zip(fqz_model_torch.group_stream(ctx, qm),
                    fqz_model_jax.group_stream(ctx, qm)):
        assert np.array_equal(a, b)
    seg = np.array([3, 0, 5, 1], np.int64)
    assert np.array_equal(pass2_ref.concat_arange(seg),
                          fqz_model_jax._concat_arange(seg))
    for a, b in zip(fqz_model_torch.triples_for_stream(ctx, qm, max_sym),
                    fqz_model_jax.triples_for_stream(ctx, qm, max_sym)):
        assert np.array_equal(a, np.asarray(b))


def _group_case(kind, qdt, n=5000):
    rng = np.random.default_rng(n + len(kind))
    if kind == "random":
        ctx = (rng.integers(0, 300, n) * 1000 + 5).astype(np.uint32)
    elif kind == "hot":         # one context holds most events
        ctx = rng.integers(0, 40, n)
        ctx[rng.random(n) < 0.9] = 17
    elif kind == "equal":
        ctx = np.full(n, 123456)
    elif kind == "single":
        ctx = np.array([42])
    elif kind == "empty":
        ctx = np.zeros(0, np.int64)
    else:                       # "jobs": job * 2^32 + model id
        ctx = (rng.integers(0, 5, n) * adaptive_batch.JOB_OFF
               + rng.integers(0, 4 ** 12, n))
    return ctx, rng.integers(0, 256, len(ctx)).astype(qdt)


@pytest.mark.parametrize("kind,qdt", [
    (k, q) for k in ("random", "hot", "equal", "single", "empty", "jobs")
    for q in (np.uint8, np.int32)])
def test_group_stream_torch_matches_group_stream(kind, qdt):
    """The device grouping gives group_stream's five arrays, value for
    value, and dtype for dtype past the keys."""
    ctx, qm = _group_case(kind, qdt)
    got = fqz_model_torch.group_stream_torch(_t(ctx.astype(np.int64)),
                                             _t(qm))
    want = fqz_model_torch.group_stream(ctx, qm)
    assert np.array_equal(got[0].numpy(), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.numpy().dtype == b.dtype
        assert np.array_equal(a.numpy(), b)


def _pass2_preps(kind):
    """_prep_job-like tuples of a batch whose events are _group_case's:
    jobs by key // JOB_OFF (each job's events in stream order), spread
    over the four families, TinyModel symbols below their alphabet.
    "wide": "random" with a quarter of the events moved to the selector
    model of N128, whose 200-symbol alphabet takes the 256-slot walk."""
    ctx, qm = _group_case("random" if kind == "wide" else kind, np.int32)
    rng = np.random.default_rng(len(ctx) + 7)
    fam = rng.integers(0, 4, len(ctx)).astype(np.int8)
    sym = np.where(fam == adaptive_batch.F_T4, qm % 4,
                   np.where(fam == adaptive_batch.F_T2, qm % 2, qm))
    mid = ctx.astype(np.int64) % adaptive_batch.JOB_OFF
    meta = (41, 3)
    if kind == "wide":
        sel = rng.random(len(ctx)) < 0.25
        fam[sel] = adaptive_batch.F_N128
        mid[sel] = port_fqz.MID_SEL
        sym[sel] = rng.integers(0, 200, int(sel.sum()))
        meta = (41, 200)
    job = ctx.astype(np.int64) // adaptive_batch.JOB_OFF
    return [(b"", fam[job == j], mid[job == j], sym[job == j].astype(np.int32),
             None, meta if j % 2 == 0 else None)
            for j in range(int(job.max(initial=0)) + 1)]


@pytest.mark.parametrize("kind", ["random", "hot", "equal", "single",
                                  "empty", "jobs", "wide"])
def test_device_pass2_matches_numpy_path(kind, monkeypatch):
    """Pass 2 kept on the device from the sort to DevTriples (buckets
    worked out, planes built and triples scattered there) launches the
    numpy path's walks on the same planes, in the same order, and gives
    its cf/tot in event order, on one device and over a 3x1 mesh; the
    numpy path groups each family on the host, builds the planes there
    and un-sorts on the host.  "wide" runs N128 rows on both walks."""
    preps = _pass2_preps(kind)
    launches = []

    def spy(name):
        walk = getattr(model_cuda, name)

        def run(sp, ct, arg, *a):
            launches.append((name, tuple(sp.shape), sp.numpy().tobytes(),
                             arg if name == "tiny_evolve" else arg.tolist()))
            return walk(sp, ct, arg, *a)
        monkeypatch.setattr(model_cuda, name, run)
    for name in ("tiny_evolve", "evolve_128", "evolve_256"):
        spy(name)
    want = pass2_ref.pass2_np(preps, CPU)
    numpy_launches, launches[:] = launches[:], []
    for device in (CPU, Mesh([CPU] * 3, 3, 1)):
        dev = adaptive_batch.DevTriples(len(want[0]), CPU)
        adaptive_batch._evolve_families(preps, dev, device)
        assert np.array_equal(dev.cf.numpy(), want[0])
        assert np.array_equal(dev.tot.numpy(), want[1])
        if device is CPU:
            assert launches == numpy_launches
    assert any(200 in a for n, _, _, a in numpy_launches
               if n == "evolve_256") == (kind == "wide")


def test_device_pass2_refuses_symbols_past_a_byte():
    preps = _pass2_preps("random")
    preps[0][3][5] = 256
    with pytest.raises(ValueError, match="exceed a byte"):
        adaptive_batch._evolve_families(
            preps, adaptive_batch.DevTriples(5000, CPU), CPU)


# ---------------------------------------------------------------------
# pass 3: the range coder

def _rc_case(seed, B, T):
    """(cum, freq, tot) (B, T) planes: random models (carries), small
    TinyModel-like totals, and a row of least-probable top symbols of a
    power-of-two total, which keeps low + range at the top of the range
    and so defers long 0xFF runs, broken twice by likely symbols."""
    rng = np.random.default_rng(seed)
    tot = rng.integers(2, 65519, (B, T)).astype(np.uint32)
    tot[1] = rng.integers(2, 300, T)
    freq = np.minimum(rng.integers(1, 65519, (B, T)), tot).astype(np.uint32)
    freq[1] = np.maximum(1, freq[1] // 3)
    cum = (rng.random((B, T)) * (tot - freq + 1)).astype(np.uint32)
    tot[2] = 1 << 15
    freq[2] = 1
    cum[2] = (1 << 15) - 1
    for a in (0, T // 2):
        freq[2, a:a + 5] = 1 << 14
        cum[2, a:a + 5] = 0
    return cum, freq, tot


def _jax_payloads(cum, freq, tot, lens):
    act = np.arange(cum.shape[1])[None, :] < lens[:, None]
    st, ev = rc_jax.encode_scan(cum, freq, tot, active=act)
    tails = rc_jax.finish_events(st)
    fl, ca, ff, cy = map(np.asarray, ev)
    return [rc_jax.assemble_stream(fl[b], ca[b], ff[b], cy[b], tails[b])
            for b in range(len(lens))]


def _flat(cum, freq, tot, lens):
    cf = ((cum.astype(np.int64) << 16) | freq).astype(np.uint32)
    parts = [(cf[b, :lens[b]], tot[b, :lens[b]]) for b in range(len(lens))]
    starts = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    return (_t(np.concatenate([p[0] for p in parts]).view(np.int32)),
            _t(np.concatenate([p[1] for p in parts]).astype(np.int32)),
            starts)


def test_rc_walk_matches_jax_scan_chunked(monkeypatch):
    """Ragged lengths, an empty stream, carry and 0xFF runs, walked in
    short chunks so runs straddle chunk boundaries."""
    B, T = 5, 1500
    cum, freq, tot = _rc_case(1, B, T)
    lens = np.array([1500, 1100, 1499, 0, 1], np.int64)
    cf, tt, starts = _flat(cum, freq, tot, lens)
    monkeypatch.setattr(adaptive_batch, "CHUNK_T", 256)
    got = adaptive_batch.rc_walk(cf, tt, starts, lens)
    want = _jax_payloads(cum, freq, tot, lens)
    assert got == want
    # a deferred 0xFF run longer than two chunks, and carries
    _, (fl, _, ff, cy) = rc_jax.encode_scan(cum, freq, tot)
    fl, ff, cy = map(np.asarray, (fl, ff, cy))
    assert (ff[2] * fl[2]).max() > 2 * 256
    assert (fl[0] & (cy[0] > 0)).any()
    assert got[3] == rc_torch.finish_events(rc_torch.init_state(1))[0]


def test_rc_walk_matches_pallas_compact_idx():
    B, T = 3, 512
    cum, freq, tot = _rc_case(2, B, T)
    lens = np.array([512, 300, 511], np.int64)
    cf, tt, starts = _flat(cum, freq, tot, lens)
    got = adaptive_batch.rc_walk(cf, tt, starts, lens)
    flat = [np.concatenate([x[b, :lens[b]] for b in range(B)]).astype(
        np.int32) for x in (cum, freq, tot)]
    sent = len(flat[0])
    V = tuple(jnp.asarray(np.append(v, d)) for v, d in zip(flat, (0, 1, 2)))
    idx = np.full((B, T), sent, np.int32)
    for b in range(B):
        idx[b, :lens[b]] = starts[b] + np.arange(lens[b])
    state, by, totals = rc_pallas.encode_walk_compact_idx(V, idx,
                                                          interpret=True)
    tails = rc_jax.finish_events(state)
    want = [by[b, :totals[b]].tobytes() + tails[b] for b in range(B)]
    assert got == want


def test_rc_walk_continues_a_jax_state():
    """A stream's first chunk walked by JAX, the rest by the port from
    JAX's carried state."""
    B, T, cut = 3, 1200, 700
    cum, freq, tot = _rc_case(3, B, T)
    lens = np.full(B, T, np.int64)
    st, ev = rc_jax.encode_scan(cum[:, :cut], freq[:, :cut], tot[:, :cut])
    fl, ca, ff, cy = map(np.asarray, ev)
    head = [rc_jax.assemble_stream(fl[b], ca[b], ff[b], cy[b], b"")
            for b in range(B)]
    state = _t(np.stack([np.asarray(x, np.uint32) for x in st]).view(
        np.int32))
    cf, tt, starts = _flat(cum[:, cut:], freq[:, cut:], tot[:, cut:],
                           lens - cut)
    n = _t((lens - cut).astype(np.int32))
    out, totals, state = rc_cuda.encode_walk(
        cf, tt, _t(starts), n, state, rc_torch.cap_for(T - cut, 64))
    tails = rc_torch.finish_events(state)
    got = [head[b] + out[b, :int(totals[b])].numpy().tobytes() + tails[b]
           for b in range(B)]
    assert got == _jax_payloads(cum, freq, tot, lens)


def test_rc_walk_raises_when_room_is_short():
    cum, freq, tot = _rc_case(4, 3, 200)
    lens = np.full(3, 200, np.int64)
    cf, tt, starts = _flat(cum, freq, tot, lens)
    with pytest.raises(ValueError, match="room"):
        rc_cuda.encode_walk(cf, tt, _t(starts), _t(lens.astype(np.int32)),
                            rc_torch.init_state(3), 8)


# ---------------------------------------------------------------------
# pass 1 and the parameter tables

def _fqz_case(seed, nrec=120, fixed=False, with_seq=False, strat=1,
              width=40):
    rng = np.random.default_rng(seed)
    lens = (np.full(nrec, 100, np.uint32) if fixed
            else rng.integers(40, 160, nrec).astype(np.uint32))
    total = int(lens.sum())
    q = np.clip(np.cumsum(rng.integers(-2, 3, total)) % width + 3,
                0, 255).astype(np.uint8)
    if fixed:
        q[100:200] = q[:100]   # a duplicate record
    flags = np.zeros(nrec, np.uint32)
    seq = (bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), total))
           if with_seq else None)
    return ("fqz", bytes(q), lens, flags, seq, strat)


def _seq_case(seed, nrec=80, both=0, slevel=10, alphabet=b"ACGTNacgt"):
    rng = np.random.default_rng(seed)
    lens = rng.integers(50, 150, nrec).astype(np.uint32)
    total = int(lens.sum())
    p = np.array([.24, .24, .24, .22, .02, .01, .01, .01, .01])
    p = p[:len(alphabet)] / p[:len(alphabet)].sum()
    seq = bytes(rng.choice(np.frombuffer(alphabet, np.uint8), total, p=p))
    return ("seq", seq, lens, both, slevel)


def test_params_to_torch_matches_parse():
    _, q, lens, flags, seq, strat = _fqz_case(7, strat=3, with_seq=True)
    _, P, _ = port_fqz.prepare_fqz(q, lens, flags, seq, strat)
    _, PJ, _ = fqz_device_encode.prepare_fqz(q, lens, flags, seq, strat)
    for f in ("nparam", "gflags", "max_sel", "max_sym"):
        assert getattr(P, f) == getattr(PJ, f)
    tabs = fqz_ctx_torch.params_to_torch(P, CPU)
    assert set(tabs) == {"qmap", "qtab", "ptab", "dtab", "qshift", "qmask",
                         "qloc", "sloc", "context", "bbits", "bloc"}
    for k, v in tabs.items():
        assert v.dtype == torch.int64
        assert np.array_equal(v.numpy(), getattr(PJ, k).astype(np.int64))
    for f in ("stab", "boff", "do_sel", "do_dedup", "fixed_len"):
        assert np.array_equal(getattr(P, f), getattr(PJ, f))


def test_compute_contexts_matches_jax():
    _, q, lens, flags, _, _ = _fqz_case(8, strat=2)
    _, P, sels = port_fqz.prepare_fqz(q, lens, flags, None, 2)
    pidx = sels.astype(np.int64)
    L = int(lens.max())
    quals = np.zeros((len(lens), L), np.uint8)
    qa = np.frombuffer(q, np.uint8)
    ends = np.cumsum(lens.astype(np.int64))
    for r, (a, b) in enumerate(zip(ends - lens, ends)):
        quals[r, :b - a] = qa[a:b]
    ctx, qm = fqz_ctx_torch.compute_contexts(
        _t(quals), _t(lens.astype(np.int64)), _t(pidx),
        _t(sels.astype(np.int64)), fqz_ctx_torch.params_to_torch(P, CPU))
    cj, qj = fqz_ctx_jax.compute_contexts(
        quals, lens, pidx.astype(np.int32), sels, P.qmap, P.qtab, P.ptab,
        P.dtab, P.qshift, P.qmask, P.qloc, P.sloc, P.context)
    m = np.arange(L)[None, :] < lens[:, None]
    assert np.array_equal(ctx.numpy()[m], np.asarray(cj)[m])
    assert np.array_equal(qm.numpy()[m], np.asarray(qj)[m])


@pytest.mark.parametrize("strat,with_seq,fixed", [
    (0, False, True), (1, False, False), (2, True, False), (3, True, True)])
def test_build_stream_matches_jax(strat, with_seq, fixed):
    """The merged (model id, symbol) stream, pass 1 included, with and
    without sequence-conditioned contexts."""
    _, q, lens, flags, seq, _ = _fqz_case(9 + strat, fixed=fixed,
                                          with_seq=with_seq)
    _, P, sels = port_fqz.prepare_fqz(q, lens, flags, seq, strat)
    got = port_fqz.build_stream(q, lens, sels, P, CPU, seq=seq)
    want = fqz_device_encode.build_stream(q, lens, sels, P, seq=seq)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    if with_seq and strat == 3:
        assert P.bbits.any()   # seq conditioning took part


@pytest.mark.parametrize("slevel", [10, 13])
def test_seq_contexts_and_events_match_jax(slevel):
    codes = np.random.default_rng(slevel).choice(
        np.array([0, 1, 2, 3, 4, 0x80, 0x83], np.int32), (30, 90))
    got = port_seq.seq_contexts(_t(codes), slevel)
    want = seq_device_encode.seq_contexts(codes, slevel)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.int64),
                              np.asarray(b).astype(np.int64))
    for both in (0, 1):
        _, seq, lens, _, _ = _seq_case(slevel + both)
        got = port_seq.build_events(seq, lens, both, slevel, CPU)
        want = seq_device_encode.build_events(seq, lens, both, slevel)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------
# whole jobs

def _host_encode(job):
    if job[0] == "fqz":
        _, q, lens, flags, seq, strat = job
        return host.fqz_compress(q, lens, flags, seq, strat)
    _, seq, lens, both, slevel = job
    return host.seq_encode(seq, lens, both, slevel)


def test_batch_matches_jax_batch_and_host_codecs():
    """A mixed 6-job batch (fqz strategies, seq both-strands on and off)
    gives the JAX batch's payloads, which are the host codecs'."""
    jobs = [
        _fqz_case(1),
        _fqz_case(2, fixed=True, strat=0),
        _seq_case(3),
        _fqz_case(4, with_seq=True, strat=3),
        _seq_case(5, both=1, slevel=12),
        _fqz_case(6, strat=2),
    ]
    got = adaptive_batch.encode_adaptive_batch(jobs, CPU)
    assert got == jax_batch.encode_adaptive_batch(jobs)
    assert got == [_host_encode(j) for j in jobs]


def test_batch_groups_every_pass2_event(monkeypatch):
    """Several jobs (keys past 2^32), seq update-only events among them:
    the host codecs' payloads, and every pass-2 event grouped on the
    device and put in a plane there (plane_events and group_events equal
    pass2_events)."""
    from fqzcomp5_tpu_torch.ops import devtimer

    monkeypatch.setattr(devtimer, "enabled", True)
    monkeypatch.setattr(devtimer, "_log",
                        type(devtimer._log)(maxlen=devtimer.MAX_SPANS))
    jobs = [_fqz_case(31, with_seq=True, strat=3),
            _seq_case(32, both=1, slevel=12), _seq_case(33)]
    with devtimer.span("encode"):
        got = adaptive_batch.encode_adaptive_batch(jobs, CPU)
    devtimer.reset()
    assert got == [_host_encode(j) for j in jobs]
    counts = next(s for s in devtimer.spans() if s.name == "encode").counts
    assert (counts["plane_events"] == counts["group_events"]
            == counts["pass2_events"] > 0)


def test_batch_budget_split_and_empty_jobs(monkeypatch):
    """Jobs share no state: a batch split by the budget, an empty seq
    job and a one-record fqz job give the host codecs' payloads."""
    jobs = [_seq_case(21, alphabet=b"ACGT"),
            ("seq", b"", np.zeros(0, np.uint32), 0, 10),
            _fqz_case(22, nrec=1), _seq_case(23, both=1, slevel=12)]
    monkeypatch.setattr(adaptive_batch, "_batch_budget_bytes",
                        lambda: max(len(j[1]) for j in jobs) + 1)
    got = adaptive_batch.encode_adaptive_batch(jobs, CPU)
    assert got == [_host_encode(j) for j in jobs]


def test_wide_alphabet_declines_before_device_work(monkeypatch):
    """A quality alphabet of 96 symbols or more: the native codec
    declines, and the port's batch gives None for that job only, before
    any device walk."""
    wide = _fqz_case(99, width=200)
    with pytest.raises(ValueError):
        host.fqz_compress(*wide[1:])
    calls = []
    monkeypatch.setattr(port_fqz, "build_stream",
                        lambda *a, **k: calls.append(1))
    assert adaptive_batch._prep_job(wide, CPU) is None
    assert not calls
    monkeypatch.undo()
    ok = _seq_case(98)
    assert adaptive_batch.encode_adaptive_batch([wide, ok], CPU) == [
        None, _host_encode(ok)]
