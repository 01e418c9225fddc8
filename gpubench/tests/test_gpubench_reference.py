"""The plain reference reads what the program writes: each decoder on
payloads of the program's host codecs, and whole archives of its CUDA
engine run on the CPU; a payload changed where it is made is caught."""

import io
import struct
import zlib

import numpy as np
import pytest

from gbench import (ref_archive, ref_fqz, ref_lzp, ref_rans, ref_seq,
                    ref_tok3, registry, traffic)

host = pytest.importorskip("fqzcomp5_tpu_torch.codecs.host")


def _reads(name="err174310-l5.roundtrip", n=800, seed=11):
    cfg = registry.Cell(registry.load_benchmark(), name).config
    return traffic.reads(cfg, seed, n=n)


@pytest.mark.parametrize("order", [0, 1, 4, 5, 0x80, 0x81, 0x84, 0x85, 0x40,
                                   0x41, 0xC1, 0x20, 8, 9, 0x89,
                                   (101 << 8) | 9])
def test_rans_orders(order):
    r = _reads(n=400)
    for data in (r.seq.tobytes(), (r.qual - 33).tobytes(),
                 b"\0".join(r.names) + b"\0", b"A" * 3000, b"xy"):
        pay = host.rans_compress(data, order)
        assert ref_rans.uncompress(pay) == data, (order, len(data))


def test_lzp_expand_and_a_changed_byte():
    r = _reads(n=600)
    names = b"\0".join(r.names) + b"\0"
    lz = host.lzp(names)
    assert ref_lzp.expand(lz, names) == names
    bad = bytearray(lz)
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(ref_lzp.LzpMismatch):
        ref_lzp.expand(bytes(bad), names)
    esc = bytes([233, 234, 1, 2, 233]) * 50
    assert ref_lzp.expand(host.lzp(esc), esc) == esc


@pytest.mark.parametrize("level", [3, 5, 9])
def test_tok3(level):
    r = _reads(n=500)
    names = b"\0".join(r.names) + b"\0"
    other = b"\0".join([b"r%d/%d" % (i, 1 + i % 2) for i in range(200)]
                       + [b"q", b"q", b"A0:%03d" % 7]) + b"\0"
    for blk in (names, other):
        assert ref_tok3.decode(host.tok3_encode(blk, level, 0)) == blk


@pytest.mark.parametrize("both,k", [(0, 10), (1, 12)])
def test_seq_model(both, k):
    r = _reads(n=300)
    seq = bytearray(r.seq.tobytes())
    seq[50:60] = b"NNNNNNNNNN"
    seq[500:520] = b"acgtacgtacgtacgtacgt"
    lens = np.full(300, r.seq.shape[1], np.uint32)
    pay = host.seq_encode(bytes(seq), lens, both, k)
    assert ref_seq.decode(pay, list(lens), both, k, len(seq)) == seq


@pytest.mark.parametrize("strat", [0, 1, 2, 3, 4])
def test_fqz_model(strat):
    r = _reads(n=300)
    q = (r.qual - 33).tobytes()
    lens = np.full(300, r.seq.shape[1], np.uint32)
    pay = host.fqz_compress(q, lens, np.zeros(300, np.uint32),
                            r.seq.tobytes(), strat)
    assert ref_fqz.decode(pay, len(q), r.seq.tobytes()) == q


def _archive(tmp_path, preset, r, engine, blk=None):
    import torch
    from fqzcomp5_tpu_torch import cli, cuda_driver, drivers

    arg, _, _ = cli.parse_args([preset, "-V"])
    arg.nthread = 1
    if blk:
        arg.blk_size = blk
    path = str(tmp_path / "in.fastq")
    with open(path, "wb") as fp:
        fp.write(traffic.fastq(r))
    out = io.BytesIO()
    if engine == "cuda":
        cuda_driver.encode_file(path, out, arg, cuda_driver.Timings(),
                                torch.device("cpu"))
    else:
        drivers.encode_file(path, out, arg, drivers.Timings(), None)
    return out.getvalue()


@pytest.mark.parametrize("preset,engine,blk", [("-1", "cuda", 40_000),
                                                ("-5", "cuda", None),
                                                ("-5", "host", 60_000)])
def test_whole_archives(tmp_path, preset, engine, blk):
    r = _reads(n=500)
    a = _archive(tmp_path, preset, r, engine, blk)
    rep = ref_archive.check(a, r)
    assert rep.bad_blocks == 0 and rep.first_error == ""
    assert rep.records == 500


def test_card_streams_count_states_and_words(tmp_path):
    # the 32-lane streams' symbols and the bytes a walk reads of them
    r = _reads(n=500)
    a = _archive(tmp_path, "-1", r, "cuda", 40_000)
    streams = ref_archive.card_streams(a)
    syms = sum(s for s, _ in streams.values())
    assert 0 < syms <= 2 * 500 * r.seq.shape[1]
    assert all(0 < b < s for s, b in streams.values() if s)
    assert ref_archive.check(a, r).kinds == {"rANS"}


def _refit_crc(a, off):
    """The archive with the CRC of the block at off recomputed."""
    a = bytearray(a)
    size = struct.unpack_from("<I", a, off)[0]
    struct.pack_into("<I", a, off + 8,
                     zlib.crc32(bytes(a[off + 12:off + 4 + size])))
    return bytes(a)


def test_changed_payload_byte_fails_even_with_a_sound_crc(tmp_path):
    r = _reads(n=500)
    a = _archive(tmp_path, "-1", r, "cuda", 40_000)
    for frac in (0.3, 0.6, 0.9):
        bad = bytearray(a)
        size = struct.unpack_from("<I", a, 16)[0]
        pos = 16 + int(12 + frac * (size - 8))
        bad[pos] ^= 0x04
        rep = ref_archive.check(_refit_crc(bytes(bad), 16), r)
        assert rep.bad_blocks > 0
    rep = ref_archive.check(a, _reads(n=500, seed=12))
    assert rep.bad_blocks > 0


def _first_length(a):
    """Offset in the archive of the last byte of the first block's first
    length varint; the block's lengths must be stored one a record."""
    off = 16 + 12                                  # names [ulen][strat]
    clen = struct.unpack_from("<I", a, off + 5)[0]
    off += 9 + clen
    assert a[off] == 0                             # varints, no fixed length
    off += 5
    while a[off] & 0x80:
        off += 1
    return off


@pytest.mark.parametrize("preset,blk,kinds", [("-1", 500_000, {"rANS"}),
                                               ("-5", None, {"FQZ"})])
def test_ragged_archives_host_engine(tmp_path, preset, blk, kinds):
    # reads of 25-400 bases: every block holds its lengths as varints,
    # and the reference holds them record by record
    from helpers import ragged_config

    r = traffic.reads(ragged_config(2_000_000), 2 ** 34 + 21)
    a = _archive(tmp_path, preset, r, "host", blk)
    rep = ref_archive.check(a, r)
    assert rep.bad_blocks == 0 and rep.first_error == ""
    assert rep.records == len(r) and rep.blocks >= (4 if blk else 1)
    assert kinds <= rep.kinds and (preset != "-1" or rep.kinds == kinds)
    off, r0 = 16, 0
    while off < struct.unpack_from("<Q", a, 8)[0]:
        size = struct.unpack_from("<I", a, off)[0]
        b = ref_archive._layout(a[off:off + 4 + size])
        assert b.len_strat == 0
        assert (b.lens == r.lens[r0:r0 + b.nrec]).all()
        off, r0 = off + 4 + size, r0 + b.nrec
    # one length changed in the expected reads, then in the archive
    lens = r.lens.copy()
    lens[len(r) // 3] -= 1
    rep = ref_archive.check(a, ref_archive.Reads(r.names, r.seq, r.qual,
                                                 lens))
    assert rep.bad_blocks > 0 and "length" in rep.first_error
    bad = bytearray(a)
    bad[_first_length(a)] ^= 1
    rep = ref_archive.check(_refit_crc(bytes(bad), 16), r)
    assert rep.bad_blocks > 0 and "length" in rep.first_error
