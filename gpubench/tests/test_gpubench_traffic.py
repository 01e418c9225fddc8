"""The generator: one seed, one file; the shape the configuration states."""

import re

import numpy as np
import pytest

from gbench import registry, traffic

from helpers import ragged_config


def _cfg(name):
    return registry.Cell(registry.load_benchmark(), name).config


def test_same_seed_same_bytes():
    cfg = _cfg("err174310-l1.roundtrip")
    a = traffic.fastq(traffic.reads(cfg, 2 ** 31 + 99, n=500))
    b = traffic.fastq(traffic.reads(cfg, 2 ** 31 + 99, n=500))
    c = traffic.fastq(traffic.reads(cfg, 2 ** 31 + 98, n=500))
    assert a == b
    assert a != c


def test_reads_have_the_configured_shape():
    cfg = _cfg("err174310-l5.roundtrip")
    r = traffic.reads(cfg, 12345678901, n=2000)
    L = cfg["read_length"]
    assert r.seq.shape == r.qual.shape == (2000, L)
    assert set(np.unique(r.seq).tobytes()) <= set(b"ACGT")
    q = cfg["quality"]
    assert r.qual.min() >= 33 + q["phred_min"]
    assert r.qual.max() <= 33 + q["phred_max"]
    pat = re.compile(rb"ERR174310\.(\d+) HSQ1004:134:C0D8DACXX:2:(\d+):"
                     rb"(\d+):(\d+)/1")
    for k, name in enumerate(r.names):
        m = pat.fullmatch(name)
        assert m and int(m[1]) == k + 1
        assert int(m[2]) in cfg["names"]["tiles"]
        lo, hi = cfg["names"]["x_range"]
        assert lo <= int(m[3]) <= hi
    gc = np.isin(r.seq, np.frombuffer(b"CG", np.uint8)).mean()
    assert abs(gc - 0.41) < 0.015
    # quality falls along the read; some reads end in a run of the lowest
    phred = r.qual.astype(int) - 33
    assert phred[:, :10].mean() > phred[:, -10:].mean() + 3
    low = (phred[:, -1] == q["tail_phred"]).mean()
    assert 0.5 * q["tail_share"] < low < 1.5 * q["tail_share"]


def test_repeat_families_recur_across_seeds():
    # every seed draws copies of the same families: a 16-mer of the Alu
    # consensus turns up in the reads of two seeds
    cfg = _cfg("err174310-l5.roundtrip")
    cons, fam = traffic._families(cfg["bases"])[0]
    word = traffic._BASES[cons[100:116]].tobytes()
    rc = bytes(b"TGCA"[b"ACGT".index(c)] for c in reversed(word))
    for seed in (3, 2 ** 40 + 3):
        text = traffic.fastq(traffic.reads(cfg, seed, n=4000))
        assert text.count(word) + text.count(rc) > 0


@pytest.mark.parametrize("preset,seq,qual", [("-5", 1, 1), ("-1", 0, 0)])
def test_fqzcomp5_codecs_choose_as_the_source_did(tmp_path, preset, seq,
                                                   qual):
    # fqzcomp5's own codecs (the port's host engine) on a 2 MB file: at -5
    # the trial keeps the SEQ model for bases and FQZ for qualities, as on
    # ERR174310 (the source table: seq and qual smaller at -5 than at -1)
    import struct
    import subprocess
    import sys

    from gbench import ref_archive

    cfg = dict(_cfg("err174310-l5.roundtrip"), file_bytes=2_000_000)
    path = tmp_path / "in.fastq"
    path.write_bytes(traffic.fastq(traffic.reads(cfg, 2 ** 33 + 5)))
    out = tmp_path / "out.fqz5"
    subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "-e",
                    "host", preset, "-V", str(path), str(out)], check=True,
                   cwd=registry.ROOT)
    data = out.read_bytes()
    size = struct.unpack_from("<I", data, 16)[0]
    b = ref_archive._layout(data[16:20 + size])
    assert (b.seq[0] & 7 == 1) == bool(seq)
    assert (b.qual[0] != 0) == bool(qual)


def test_file_size_follows_the_configuration():
    cfg = dict(_cfg("err174310-l1.roundtrip"), file_bytes=300_000)
    n = traffic.nreads(cfg)
    data = traffic.fastq(traffic.reads(cfg, 5))
    assert data.count(b"\n") == 4 * n
    assert abs(len(data) - 300_000) < 0.02 * 300_000


# sha256 of the FASTQ the generator drew for each cell's configuration
# before it took reads of varying length: its first 20,000 reads, and the
# -5 cell's whole file
PINNED = [
    ("err174310-l1.roundtrip", 7, 20000,
     "9f22aa2ed4056996b62e32bec1ccfcc8c974e726459ac67aceda6dd76e228de8"),
    ("err174310-l1.roundtrip", 2 ** 31 + 5, 20000,
     "4d159a0bcd9a1d3626d67fedfec288e96055f69a80efde274680cc9a33f827e9"),
    ("err174310-l1.roundtrip", 2 ** 40 + 17, 20000,
     "50d1499350a4472eb103a683e94c62f3153f97dc49e52612c9e3f322a3281165"),
    ("err174310-l5.roundtrip", 7, 20000,
     "9f22aa2ed4056996b62e32bec1ccfcc8c974e726459ac67aceda6dd76e228de8"),
    ("err174310-l5.roundtrip", 2 ** 31 + 5, 20000,
     "4d159a0bcd9a1d3626d67fedfec288e96055f69a80efde274680cc9a33f827e9"),
    ("err174310-l5.roundtrip", 2 ** 40 + 17, 20000,
     "50d1499350a4472eb103a683e94c62f3153f97dc49e52612c9e3f322a3281165"),
    ("err174310-l5.roundtrip", 7, None,
     "4601839c89fed181f5fb149ada9c22c9db6790c9653e400740aafbc2dc8d9fad"),
    ("err174310-l5.roundtrip", 2 ** 31 + 5, None,
     "a3dd46f5a661a0753004687c827d8f54fe3514794dc5eee46f7caef69d0c4468"),
    ("err174310-l5.roundtrip", 2 ** 40 + 17, None,
     "a8ab36d08a47963b1f8532be9d978d808f0952a98d52ee08ca1ec7c29f22cf34"),
]


@pytest.mark.parametrize("name,seed,n,digest", PINNED)
def test_fixed_length_files_keep_their_bytes(name, seed, n, digest):
    import hashlib

    data = traffic.fastq(traffic.reads(_cfg(name), seed, n=n))
    assert hashlib.sha256(data).hexdigest() == digest


@pytest.mark.parametrize("name,n", [("err174310-l1.roundtrip", 480947),
                                    ("err174310-l5.roundtrip", 60522)])
def test_fixed_length_files_keep_their_read_counts(name, n):
    assert traffic.nreads(_cfg(name)) == n


def test_ragged_lengths_follow_the_histogram():
    cfg = ragged_config(20_000_000)
    bins = cfg["read_length"]["histogram"]
    lens = traffic.lengths(cfg, 20000)
    assert len(lens) == 20000
    assert all(any(lo <= v <= hi for lo, hi, _ in bins) for v in set(lens))
    total = sum(w for _, _, w in bins)
    for lo, hi, w in bins:
        share = ((lens >= lo) & (lens <= hi)).mean()
        assert abs(share - w / total) < 0.03, (lo, hi, share)
    # a file's lengths are the first of a longer file's
    assert (traffic.lengths(cfg, 700) == lens[:700]).all()


def test_ragged_seeds_share_lengths_not_bases():
    cfg = ragged_config()
    a = traffic.reads(cfg, 2 ** 31 + 3, n=3000)
    b = traffic.reads(cfg, 2 ** 40 + 3, n=3000)
    assert (a.lens == b.lens).all()
    assert len(set(a.lens.tolist())) > 100
    assert a.seq.shape == (3000, a.lens.max())
    keep = np.arange(a.seq.shape[1]) < a.lens[:, None]
    assert (a.seq[keep] != b.seq[keep]).mean() > 0.5
    assert set(np.unique(a.seq[keep]).tobytes()) <= set(b"ACGT")


@pytest.mark.parametrize("fmt,pat", [
    ("SRR1238539.{n} {n}/1", rb"SRR1238539\.(\d+) (\d+)/1"),
    ("{run}:{y:05d}:{x:05d}", rb"ZG6MK:(\d{5}):(\d{5})")])
def test_ragged_file_size_and_names(fmt, pat):
    cfg = ragged_config(600_000)
    cfg["names"].update(format=fmt, fixed={"run": "ZG6MK"},
                        x_range=[0, 3999], y_range=[0, 99999])
    r = traffic.reads(cfg, 2 ** 33 + 1)
    data = traffic.fastq(r)
    assert len(r) == traffic.nreads(cfg)
    assert abs(len(data) - 600_000) < 0.02 * 600_000
    lines = data.split(b"\n")
    assert len(lines) == 4 * len(r) + 1
    for k in range(len(r)):
        name, seq, plus, qual = lines[4 * k:4 * k + 4]
        m = re.fullmatch(rb"@" + pat, name)
        assert m, name
        if b"{n}" in fmt.encode():
            assert int(m[1]) == int(m[2]) == k + 1
        else:
            assert 0 <= int(m[2]) <= 3999
        assert len(seq) == len(qual) == r.lens[k] and plus == b"+"


def test_ragged_quality_falls_along_each_read():
    cfg = ragged_config()
    r = traffic.reads(cfg, 2 ** 35 + 9, n=4000)
    phred = r.qual.astype(int) - 33
    first, last = [], []
    for k, m in enumerate(r.lens.tolist()):
        tenth = max(1, m // 10)
        first.append(phred[k, :tenth].mean())
        last.append(phred[k, m - tenth:m].mean())
    first, last = np.array(first), np.array(last)
    assert first.mean() > last.mean() + 8
    assert (first > last).mean() > 0.95
