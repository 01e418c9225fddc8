"""The size switches of the port's wave engine on the CPU:
FQZ5_WAVE_BLOCKS and FQZ5_WAVE_MB (cuda_driver.wave_blocks,
wave_budget) and FQZ5_ADAPTIVE_BATCH_MB (adaptive_batch), read at each
call with the JAX package's defaults and units.

Under any value of the wave switches the port's archive must equal the
JAX wave engine's under the same values.  The JAX engine reads
FQZ5_WAVE_BLOCKS at import, so it runs in a subprocess with the switches
in its environment: the -e tpu encode (tpu_driver.encode_file_tpu) at a
16 KB block size, below the CLI's 1 MB clamp, so that a few hundred KB
make several waves.  The -5 input stays near 100 KB: the plain range
coder walks one stream at about 80 us a step.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch import cli, cuda_driver
from fqzcomp5_tpu_torch.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch.ops import adaptive_batch
from tests.test_torch_adaptive import _fqz_case, _seq_case

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 16_000
SWITCHED = {"FQZ5_WAVE_BLOCKS": "2", "FQZ5_WAVE_MB": "0.05"}
SWITCHES = ("FQZ5_WAVE_BLOCKS", "FQZ5_WAVE_MB", "FQZ5_ADAPTIVE_BATCH_MB")

_JAX_ENCODE = """
import sys
from fqzcomp5_tpu import tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.drivers import Timings
arg, _, _ = parse_args([sys.argv[1], "-V"])
arg.blk_size = int(sys.argv[2])
with open(sys.argv[4], "wb") as fp:
    tpu_driver.encode_file_tpu(sys.argv[3], fp, arg, Timings())
"""


def _fastq(path, nrec, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(nrec):
        L = int(rng.integers(80, 120))
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
        q = (np.cumsum(rng.integers(-2, 3, L)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@W.{i} {i}\n{seq}\n+\n{q}\n")
    path.write_text("".join(recs))
    return path


def _jax(tmp_path, preset, src, switches, name):
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env.update(switches, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    out = tmp_path / name
    subprocess.run([sys.executable, "-c", _JAX_ENCODE, preset, str(BLK),
                    str(src), str(out)], env=env, cwd=ROOT, check=True,
                   timeout=600)
    return out.read_bytes()


def _port(monkeypatch, preset, src, switches):
    """(archive, options, blocks of each wave) of the port's encode."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    arg, _, _ = cli.parse_args([preset, "-V"])
    arg.blk_size = BLK
    waves = []
    real = cuda_driver.encode_wave_blocks
    monkeypatch.setattr(cuda_driver, "encode_wave_blocks",
                        lambda lrn, a, wave, dev: waves.append(len(wave))
                        or real(lrn, a, wave, dev))
    out = io.BytesIO()
    cuda_driver.encode_file(str(src), out, arg, Timings(), CPU)
    monkeypatch.setattr(cuda_driver, "encode_wave_blocks", real)
    return out.getvalue(), arg, waves


def test_switches_read_per_call(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    assert cuda_driver.wave_blocks() == 16
    assert cuda_driver.wave_budget() == 128_000_000
    assert adaptive_batch._batch_budget_bytes() == 128 << 20
    monkeypatch.setenv("FQZ5_WAVE_BLOCKS", "3")
    monkeypatch.setenv("FQZ5_WAVE_MB", "0.5")
    monkeypatch.setenv("FQZ5_ADAPTIVE_BATCH_MB", "2")
    assert cuda_driver.wave_blocks() == 3
    assert cuda_driver.wave_budget() == 500_000
    assert adaptive_batch._batch_budget_bytes() == 2 << 20
    assert cuda_driver.wave_groups_from_sizes([10] * 7) == [3, 3, 1]
    assert cuda_driver.wave_groups_from_sizes([300_000] * 3) == [2, 1]


@pytest.mark.parametrize("preset,nrec", [("-1", 1500), ("-5", 450)])
def test_archives_under_wave_switches_equal_jax(tmp_path, monkeypatch,
                                                 preset, nrec):
    """At the defaults and under FQZ5_WAVE_BLOCKS=2 FQZ5_WAVE_MB=0.05,
    the port's archive equals the JAX engine's under the same values,
    and decodes to the source under them; the switched archive also
    equals the default one (the learner's outcome does not depend on
    the wave size)."""
    src = _fastq(tmp_path / "in.fastq", nrec, seed=len(preset) + nrec)
    got, waves = {}, {}
    for name, sw in (("default", {}), ("switched", SWITCHED)):
        blob, arg, waves[name] = _port(monkeypatch, preset, src, sw)
        assert blob == _jax(tmp_path, preset, src, sw, f"{name}.fqz5"), name
        out = io.BytesIO()
        cuda_driver.decode_file(io.BytesIO(blob), make_fastq_writer(out, arg),
                                arg, Timings(), CPU)
        assert out.getvalue() == src.read_bytes()
        got[name] = blob
    assert max(waves["switched"]) <= 2 < max(waves["default"])
    assert sum(waves["switched"]) == sum(waves["default"])
    assert got["switched"] == got["default"]


def test_adaptive_batch_budget_switch_splits(monkeypatch):
    """FQZ5_ADAPTIVE_BATCH_MB=0 runs each job as a batch of its own; the
    payloads equal the unsplit batch's."""
    jobs = [_fqz_case(51), _seq_case(52, both=1, slevel=12),
            _fqz_case(53, with_seq=True, strat=3), _seq_case(54)]
    chunks = []
    real = adaptive_batch._encode_chunk
    monkeypatch.setattr(adaptive_batch, "_encode_chunk",
                        lambda js, dev: chunks.append(len(js))
                        or real(js, dev))
    monkeypatch.delenv("FQZ5_ADAPTIVE_BATCH_MB", raising=False)
    whole = adaptive_batch.encode_adaptive_batch(jobs, CPU)
    assert chunks == [4]
    monkeypatch.setenv("FQZ5_ADAPTIVE_BATCH_MB", "0")
    assert adaptive_batch.encode_adaptive_batch(jobs, CPU) == whole
    assert chunks == [4, 1, 1, 1, 1]
