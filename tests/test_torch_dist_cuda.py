"""The wave engine under several processes
(fqzcomp5_tpu_torch.parallel.dist_cuda) on the CPU, over gloo.

Ranks of the port's entry run ``-e cuda`` with ``--device cpu`` (the
plain versions); two waves of small blocks go round-robin over them.
Their archive must equal ``fqzcomp5_tpu -e tpu``'s single-process one,
with each wave parsed by its owner only, also when each rank runs a
local mesh (FQZ5_DIST_LOCAL_MESH), and it must decode back to the
source.
"""

import io
import os

import pytest

from fqzcomp5_tpu import tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.drivers import Timings
from tests.test_torch_distributed import (check_ok, make_fastq, rank_stats,
                                          run_ranks)

# block size by preset: -5's sections at 12 KB still reach the device
BLK = {"-1": 16 << 10, "-5": 12 << 10}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{preset: (path, data, -e tpu archive)}: about 19 blocks at -1 and
    21 at -5, in two waves each."""
    d = tmp_path_factory.mktemp("dist_cuda")
    out = {}
    for preset, n in (("-1", 1600), ("-5", 1300)):
        src = d / f"in{preset}.fastq"
        data = make_fastq(src, n=n, seed=11)
        arg, _, _ = parse_args([preset, "-V"])
        arg.blk_size = BLK[preset]
        ref = io.BytesIO()
        tpu_driver.encode_file_tpu(str(src), ref, arg, Timings())
        out[preset] = (src, data, ref.getvalue())
    return out


@pytest.mark.parametrize("preset, nprocs, mesh", [
    ("-1", 2, None), ("-1", 3, None), ("-5", 2, None), ("-1", 2, "1x2")])
def test_cuda_engine_matches_tpu_engine(tmp_path, inputs, preset, nprocs,
                                        mesh):
    src, data, want = inputs[preset]
    out = tmp_path / "dist.fqz5"
    env = {"FQZ5_DIST_LOCAL_MESH": mesh} if mesh else {}
    outs = run_ranks(nprocs, [preset, "-b", BLK[preset], "-e", "cuda",
                              "--device", "cpu", src, out], env=env)
    check_ok(outs)
    assert out.read_bytes() == want
    # parse once: every block parsed by its wave's owner only; with two
    # waves, ranks 0 and 1 own one each
    st = rank_stats(outs)
    assert sum(s["parse_bytes"] for s in st) == os.path.getsize(src)
    assert st[0]["parse_bytes"] > 0 and st[1]["parse_bytes"] > 0
    if nprocs == 3:
        assert st[2]["parse_bytes"] == 0 and st[2]["blocks_ticked"] > 0
    if preset == "-1" and mesh:
        dec = tmp_path / "dec.fastq"
        check_ok(run_ranks(2, ["-d", out, dec]))
        assert dec.read_bytes() == data
