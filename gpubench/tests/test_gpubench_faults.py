"""The correctness check on the CPU: a sound run reads correct; the
control (qualities binned) and each fault the cells can have, planted in
the timed path underneath the harness, read not correct."""

import struct
import zlib

import pytest

from gbench import control, window

from helpers import cpu_run, ragged_cell, small_cell

CELLS = ["err174310-l1.roundtrip", "err174310-l5.roundtrip"]


def _verdict(run):
    return window.verdict(run.checks, run.trips)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(monkeypatch, name):
    run = cpu_run(monkeypatch, small_cell(name))
    assert _verdict(run), run.checks
    assert all(c["value"] == 0 for c in run.checks.values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(monkeypatch, name):
    run = cpu_run(monkeypatch, small_cell(name),
                  before_window=control.install)
    assert not _verdict(run)
    assert run.checks["decoded_bytes_differing"]["value"] > 0
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_on_ragged_reads_is_correct(monkeypatch, name):
    run = cpu_run(monkeypatch, ragged_cell(name))
    assert _verdict(run), run.checks
    assert all(c["value"] == 0 for c in run.checks.values())


@pytest.mark.parametrize("name", CELLS)
def test_control_on_ragged_reads_is_not_correct(monkeypatch, name):
    # at -5 the port's encode of binned qualities in reads of varying
    # length raises (fqz_ctx_torch indexes qtab with the quality map's
    # value for an unused symbol): a failed round trip
    run = cpu_run(monkeypatch, ragged_cell(name),
                  before_window=control.install)
    assert not _verdict(run)
    assert run.checks["round_trips_failing"]["value"] > 0


def test_control_on_ragged_reads_changes_the_bytes(monkeypatch):
    run = cpu_run(monkeypatch, ragged_cell(CELLS[0]),
                  before_window=control.install)
    assert not _verdict(run)
    assert run.checks["decoded_bytes_differing"]["value"] > 0
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0


def _wrap_blocks(monkeypatch, change):
    """Pass every wave's serialized blocks through change(blocks)."""
    from fqzcomp5_tpu_torch import cuda_driver

    fn = cuda_driver.encode_wave_blocks

    def shim(*a, **kw):
        return change(fn(*a, **kw))
    monkeypatch.setattr(cuda_driver, "encode_wave_blocks", shim)


def _flip_in_quals(blocks):
    """One byte changed inside the first block's quality payload, where
    the encoder makes it (the block's CRC made over the change)."""
    (raw, t), *rest = blocks
    raw = bytearray(raw)
    qual_end = len(raw)
    qclen = None
    # the qualities are the block's last section: [strat][ulen][clen][pay]
    for off in range(len(raw) - 9, 11, -1):
        clen = struct.unpack_from("<I", raw, off + 5)[0]
        if off + 9 + clen == qual_end and raw[off] in (0, 1):
            qclen = clen
            break
    assert qclen
    raw[off + 9 + qclen // 2] ^= 0x21
    struct.pack_into("<I", raw, 8, zlib.crc32(bytes(raw[12:])))
    return [(bytes(raw), t), *rest]


def _drop_half(blocks):
    return blocks[:max(1, len(blocks) // 2)] if len(blocks) > 1 else []


@pytest.mark.parametrize("name", CELLS)
def test_token_altered_where_made(monkeypatch, name):
    _wrap_blocks(monkeypatch, _flip_in_quals)
    run = cpu_run(monkeypatch, small_cell(name))
    assert not _verdict(run)
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    # 1 MB blocks: the 2.5 MB file is three blocks, one wave
    cell = small_cell(CELLS[0], file_bytes=2_500_000)
    from fqzcomp5_tpu_torch import cli

    parse = cli.parse_args

    def small_blocks(argv):
        arg, d, f = parse(argv)
        arg.blk_size = 1_000_000
        return arg, d, f
    monkeypatch.setattr(cli, "parse_args", small_blocks)
    seen = []

    def drop(blocks):
        seen.append(len(blocks))
        return _drop_half(blocks) if len(blocks) > 1 else blocks
    _wrap_blocks(monkeypatch, drop)
    run = cpu_run(monkeypatch, cell)
    assert max(seen) > 1
    assert not _verdict(run)
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0
    assert run.checks["decoded_bytes_differing"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(monkeypatch, name):
    # the decode hands back an earlier state: its output for an earlier,
    # smaller request (the file's first 50 reads)
    from gbench import traffic

    def stale(run):
        prefix = run.path + ".prefix"
        with open(prefix, "wb") as fp:
            fp.write(traffic.fastq(run.reads, 50))
        run.extra_paths.append(prefix)
        out = bytes(run.port.decode(run.port.encode(prefix)))
        monkeypatch.setattr(run.port, "decode", lambda archive, sink=None: out)
    run = cpu_run(monkeypatch, small_cell(name), before_window=stale)
    assert not _verdict(run)
    assert run.checks["decoded_bytes_differing"]["value"] > 0


@pytest.mark.parametrize("kind", ["seq", "fqz"])
def test_adaptive_payload_altered_where_made(monkeypatch, kind):
    # a byte of each SEQ (or FQZ) payload the adaptive passes make,
    # changed as they return it: the winner stored in the archive
    from fqzcomp5_tpu_torch import cuda_driver

    fn = cuda_driver._adaptive_jobs

    def flip(jobs, device):
        outs = fn(jobs, device)
        return [p if p is None or j[0] != kind
                else p[:len(p) // 2] + bytes([p[len(p) // 2] ^ 1])
                + p[len(p) // 2 + 1:] for j, p in zip(jobs, outs)]
    monkeypatch.setattr(cuda_driver, "_adaptive_jobs", flip)
    run = cpu_run(monkeypatch, small_cell(CELLS[1]))
    assert not _verdict(run)
    assert run.checks["archive_blocks_failing_reference"]["value"] > 0
