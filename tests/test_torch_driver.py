"""cuda_driver's copied helpers against their originals in tpu_driver,
the port's CLI routing, and decode of the golden archives through the
port's decoder (on the CPU)."""

import io

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import container, tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch import cli, cuda_driver

CPU = torch.device("cpu")


def _sections():
    rng = np.random.default_rng(3)
    return [rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000).tobytes(),
            rng.choice(np.frombuffer(b"ACGTN", np.uint8), 4099).tobytes(),
            (rng.normal(30, 4, 6001).clip(0, 40) + 33
             ).astype(np.uint8).tobytes(),
            rng.integers(0, 256, 4096).astype(np.uint8).tobytes(),
            bytes([70]) * 4100,
            bytes([70, 71]) * 2100]


def test_pack_unpack_stripe_equal_originals():
    for d in _sections():
        p = cuda_driver.pack_np(d)
        assert p == tpu_driver.pack_np(d)
        if p is not None:
            syms = np.frombuffer(p[0][1:], np.uint8)
            assert (cuda_driver.unpack_np(p[1], len(d), syms)
                    == tpu_driver.unpack_np(p[1], len(d), syms) == d)
        for N in (1, 7, 150):
            parts = cuda_driver.stripe_split(d, N)
            assert parts == tpu_driver.stripe_split(d, N)
            assert (cuda_driver._unstripe(parts, len(d))
                    == tpu_driver._unstripe(parts, len(d)) == d)
        assert (cuda_driver._frame(0x20, len(d), d)
                == tpu_driver._frame(0x20, len(d), d))


def test_flags_and_wave_sizing_equal_originals():
    for name in ("X_PACK", "X_32", "X_STRIPE", "X_NOSZ", "X_CAT",
                 "MIN_DEVICE", "_RANS_FAMILY"):
        assert getattr(cuda_driver, name) == getattr(tpu_driver, name)
    assert cuda_driver.wave_blocks() == tpu_driver.WAVE
    assert cuda_driver.wave_budget() == tpu_driver._wave_budget()
    rng = np.random.default_rng(4)
    for sizes in ([], [5] * 40, rng.integers(1, 90_000_000, 30).tolist(),
                  [200_000_000, 1, 1]):
        assert (cuda_driver.wave_groups_from_sizes(sizes)
                == tpu_driver.wave_groups_from_sizes(sizes))


def _archive(tmp_path, preset):
    rng = np.random.default_rng(8)
    recs = []
    for i in range(300):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 90)])
        q = (rng.normal(28, 4, 90).clip(0, 40) + 33).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@R.{i}\n{seq}\n+\n{q}\n")
    src = tmp_path / "in.fastq"
    src.write_text("".join(recs))
    arg, _, _ = parse_args([preset, "-V"])
    out = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), out, arg, Timings())
    return src, out.getvalue()


@pytest.mark.parametrize("preset", ["-1", "-3"])
def test_job_parsers_equal_originals(tmp_path, preset):
    _, blob = _archive(tmp_path, preset)
    fp = io.BytesIO(blob)
    version, index_offset = container.read_header(fp)
    seen = set()
    for raw in container.iter_raw_blocks(fp, index_offset):
        m = cuda_driver._split_block(raw, version)
        assert m == tpu_driver._split_block(raw, version)
        for sec in ("seq", "qual"):
            payload = m[sec][2]
            a = cuda_driver._parse_stripe_job(payload)
            assert a == tpu_driver._parse_stripe_job(payload)
            a = cuda_driver._parse_device_job(payload)
            b = tpu_driver._parse_device_job(payload)
            assert (a is None) == (b is None)
            if a is not None:
                assert a[:3] == b[:3]
                seen.add(payload[0])
    assert seen  # device-decodable sections were exercised


@pytest.mark.parametrize("name", ["sample.L1.fqz5", "sample.L3.fqz5"])
def test_port_decodes_golden_archives(data_dir, golden_dir, name):
    arg, _, _ = parse_args(["-V"])
    out = io.BytesIO()
    with open(golden_dir / name, "rb") as fp:
        cuda_driver.decode_file(fp, make_fastq_writer(out, arg), arg,
                                Timings(), CPU)
    assert out.getvalue() == (data_dir / "sample.fastq").read_bytes()


def test_cli_strips_cuda_engine():
    """The engine flag: cuda by default and for -e cuda/-ecuda/-e auto,
    host for -e host; -e tpu is refused."""
    for argv in (["-1", "a", "b"], ["-e", "cuda", "-1", "a", "b"],
                 ["-1", "-ecuda", "a", "b"], ["-e", "auto", "-1", "a", "b"]):
        arg, decomp, files = cli.parse_args(argv)
        assert arg.engine == "cuda" and files == ["a", "b"] and not decomp
    arg, decomp, files = cli.parse_args(["-e", "host", "-d", "x", "y"])
    assert decomp and files == ["x", "y"] and arg.engine == "host"
    with pytest.raises(ValueError, match="-e tpu"):
        cli.parse_args(["-e", "tpu", "a"])


def test_cli_without_cuda_is_the_host_cli(tmp_path, data_dir, capsys):
    """Only -e host runs on the CPU: with no card, the default engine
    fails with ERROR: and writes nothing, and -e tpu is refused."""
    src = data_dir / "sample.fastq"
    comp = tmp_path / "c.fqz5"
    out = tmp_path / "o.fastq"
    assert cli.main(["-1", "-V", str(src), str(comp)]) == 1
    assert not comp.exists()
    assert "needs a CUDA device" in capsys.readouterr().err
    assert cli.main(["-e", "tpu", "-1", str(src), str(comp)]) == 1
    assert capsys.readouterr().err.startswith("ERROR:")
    assert cli.main(["-e", "host", "-1", "-V", str(src), str(comp)]) == 0
    assert cli.main(["-e", "host", "-d", "-V", str(comp), str(out)]) == 0
    assert out.read_bytes() == src.read_bytes()
    assert cli.main(["--check", str(comp)]) == 0
