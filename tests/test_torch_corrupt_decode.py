"""Corrupt archives through the port's decode, on the CPU.

Seeded byte stomps (the block CRC recomputed, so that they reach the
section decoders, as tests/test_fuzz_deep.py does for the JAX package)
and truncations of a -1 and a -3 archive that the port writes, decoded
through cuda_driver.decode_file on the CPU device with both table forms
(the s3 LUTs and the boundary tables).  Each decode must finish, or
raise an error that the port's CLI turns into ERROR: and exit 1
(cli.main catches these for archive reads); any other exception, or a
decode that does not end, is a fault of the port.  chip_smoke.py runs
the same mutations through the CLI on the card, each in a subprocess.
"""

import io
import struct

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from tests import torch_cases
from tests.test_fuzz_deep import Deadline

CPU = torch.device("cpu")
# the errors cli.main turns into ERROR: and exit 1 when it reads an
# archive
CLI_CAUGHT = (ValueError, OSError, struct.error, IndexError, KeyError,
              MemoryError)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """{preset: (source FASTQ bytes, archive bytes)}: 400 reads of 100 bp
    with random-walk qualities, encoded by the port on the CPU."""
    d = tmp_path_factory.mktemp("corrupt")
    src = d / "in.fastq"
    src.write_bytes(torch_cases.corrupt_corpus(400, 100))
    out = {}
    for lvl in ("-1", "-3"):
        arg, _, _ = cli.parse_args([lvl, "-V"])
        buf = io.BytesIO()
        cuda_driver.encode_file(str(src), buf, arg, Timings(), CPU)
        out[lvl] = (src.read_bytes(), buf.getvalue())
    return out


def _decode(raw: bytes, tables: str) -> bytes:
    arg, _, _ = cli.parse_args(["-d", "-V"])
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(raw), make_fastq_writer(out, arg),
                            arg, Timings(), CPU, tables=tables)
    return out.getvalue()


@pytest.mark.parametrize("tables", ["lut", "boundary"])
@pytest.mark.parametrize("lvl", ["-1", "-3"])
def test_archive_reaches_the_walks(archives, lvl, tables):
    """The uncorrupted archives decode to the source, through both rANS
    walks (so the mutations below reach them)."""
    from fqzcomp5_tpu_torch import engine_cuda

    src, raw = archives[lvl]
    engine_cuda.decode_o0_batch.calls = engine_cuda.decode_o1_batch.calls = 0
    assert _decode(raw, tables) == src
    assert engine_cuda.decode_o0_batch.calls and \
        engine_cuda.decode_o1_batch.calls


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tables", ["lut", "boundary"])
@pytest.mark.parametrize("lvl", ["-1", "-3"])
def test_corrupt_archive_decode_ends(archives, lvl, tables, seed):
    src, raw = archives[lvl]
    bad, what = torch_cases.corrupt_archive(raw, seed)
    assert bad != raw
    with Deadline(60):
        try:
            _decode(bad, tables)
        except CLI_CAUGHT:
            pass
        except Exception as e:  # noqa: BLE001
            pytest.fail(f"{what}: {type(e).__name__}: {e} would escape "
                        "the CLI as a traceback")
