"""The generator: one seed, one file; the shape the configuration states."""

import re

import numpy as np
import pytest

from gbench import registry, traffic


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
