"""-3 on the reads of the benchmark's err174310-l3 configuration
(gpubench/configs/err174310-l3.json), through the port's wave engine on
the CPU (its plain walks): the benchmark's generator draws the file, cut
here to 400 KB in two 200 KB blocks that share one wave and are both
trial blocks, as the cell's two 100 MB blocks are.  The archive is the
JAX engine's, byte for byte, round-trips, and the benchmark's plain
reference reads every block correct.  TOK3_3_LZP wins the names of every
block there (names strategy 2: tok3 ids, rANS flags, LZP comments), as
it does on a 16 MB file with fqzcomp5's own codecs."""

import io
import json
import os
import struct
import sys

import pytest
import torch

from fqzcomp5_tpu import cli as jax_cli, tpu_driver
from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch.ops import devtimer

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "gpubench"))
try:
    from gbench import ref_archive, traffic
finally:
    sys.path.remove(os.path.join(ROOT, "gpubench"))

FILE_BYTES = 400_000
BLK_SIZE = 200_000


@pytest.fixture
def on(monkeypatch):
    """devtimer enabled, with an empty span log of its own."""
    monkeypatch.setattr(devtimer, "enabled", True)
    monkeypatch.setattr(devtimer, "_log",
                        type(devtimer._log)(maxlen=devtimer.MAX_SPANS))
    yield devtimer
    devtimer.reset()


def _blocks(archive: bytes) -> list:
    """Each block's fields (ref_archive's layout), in file order."""
    out, off = [], 16
    index_off = struct.unpack_from("<Q", archive, 8)[0]
    while off < index_off:
        size = struct.unpack_from("<I", archive, off)[0]
        out.append(ref_archive._layout(archive[off:off + 4 + size]))
        off += 4 + size
    return out


def test_l3_reads_round_trip_and_reference(tmp_path, on):
    with open(os.path.join(ROOT, "gpubench/configs/err174310-l3.json")) as fp:
        cfg = json.load(fp)
    assert cfg["preset"] == "-3"
    cfg["file_bytes"] = FILE_BYTES
    reads = traffic.reads(cfg, 2 ** 31 + 21)
    src = tmp_path / "in.fq"
    src.write_bytes(traffic.fastq(reads))
    arg, _, _ = cli.parse_args(["-3", "-V"])
    arg.blk_size = BLK_SIZE
    blob = io.BytesIO()
    cuda_driver.encode_file(str(src), blob, arg, Timings(), CPU)
    archive = blob.getvalue()

    c = next(s for s in on.spans() if s.parent is None).counts
    assert c["blocks"] == 2 and c["waves"] == 1
    assert c["trial_blocks"] == 4 and c.get("locked_blocks", 0) == 0
    assert c["walk_steps/encode_walk"] > 0

    jax_arg, _, _ = jax_cli.parse_args(["-3", "-V"])
    jax_arg.blk_size = BLK_SIZE
    jax_out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), jax_out, jax_arg, Timings())
    assert archive == jax_out.getvalue()

    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(archive), make_fastq_writer(out, arg),
                            arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()
    rep = ref_archive.check(archive, reads)
    assert rep.bad_blocks == 0, rep.first_error
    assert rep.blocks == 2 and rep.records == len(reads)
    assert rep.kinds == set(cfg["archive_holds"])
    blocks = _blocks(archive)
    assert [b.name_strat for b in blocks] == [2, 2]
    assert all(b.seq[0] == 0 and b.qual[0] == 0 for b in blocks)
