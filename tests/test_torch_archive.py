"""Whole archives: the port's wave engine on the CPU (its plain walks)
against ``fqzcomp5_tpu -e tpu`` on the CPU, byte for byte, and the port's
decoder back to the source.

Inputs are synthetic FASTQ/FASTA of a few hundred records, so every seq
and qual section is at least MIN_DEVICE (4096) bytes and takes the
device path; fixed-length reads add the STRIPE candidate.
"""

import io

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.drivers import (Timings, make_deinterleave_writer,
                                  make_fastq_writer)
from fqzcomp5_tpu_torch import cuda_driver
from fqzcomp5_tpu_torch.ops import rans_torch

CPU = torch.device("cpu")


def _fastq(path, n, seed, fixed=True, fasta=False, tag=""):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        L = 100 if fixed else int(rng.integers(60, 140))
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, L)])
        if fasta:
            recs.append(f">chr{i}{tag}\n{seq}\n")
            continue
        q = (np.cumsum(rng.integers(-2, 3, L)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@S.{i}{tag} {i}\n{seq}\n+\n{q}\n")
    path.write_text("".join(recs))
    return path


def _encode_both(arg, files, paired=False):
    jax_out, port_out = io.BytesIO(), io.BytesIO()
    if paired:
        tpu_driver.encode_paired_tpu(*files, jax_out, arg, Timings())
        cuda_driver.encode_paired(*files, port_out, arg, Timings(), CPU)
    else:
        tpu_driver.encode_file_tpu(files[0], jax_out, arg, Timings())
        cuda_driver.encode_file(files[0], port_out, arg, Timings(), CPU)
    return jax_out.getvalue(), port_out.getvalue()


@pytest.fixture
def plain_calls(monkeypatch):
    calls = []
    for name in ("encode_walk_ref", "decode_o0_ref", "decode_o1_ref"):
        fn = getattr(rans_torch, name)
        monkeypatch.setattr(
            rans_torch, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("preset,kind,blk", [
    ("-1", "varlen", None),
    ("-3", "varlen", None),
    ("-1", "fixed", None),
    ("-3", "fixed", None),
    ("-3", "fasta", None),
    ("-1", "fixed", 32_000),
    ("-3", "varlen", 32_000),
])
def test_archive_matches_jax_engine(tmp_path, preset, kind, blk,
                                    plain_calls):
    n = 1200 if blk else 400
    src = _fastq(tmp_path / "in.fq", n, seed=len(kind) + len(preset),
                 fixed=kind != "varlen", fasta=kind == "fasta")
    arg, _, _ = parse_args([preset, "-V"])
    if blk:
        # below the CLI's 1 MB clamp: many blocks, so the learner goes
        # from trial to lock within the file
        arg.blk_size = blk
    jax_blob, port_blob = _encode_both(arg, [str(src)])
    assert port_blob == jax_blob
    assert "encode_walk_ref" in plain_calls
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(port_blob),
                            make_fastq_writer(out, arg), arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()
    assert {"decode_o0_ref", "decode_o1_ref"} & set(plain_calls)


def test_paired_archive_matches_jax_engine(tmp_path):
    r1 = _fastq(tmp_path / "r1.fq", 400, seed=1, tag="/1")
    r2 = _fastq(tmp_path / "r2.fq", 400, seed=2, tag="/2")
    arg, _, _ = parse_args(["-1", "-V"])
    arg.paired_mode = 1
    jax_blob, port_blob = _encode_both(arg, [str(r1), str(r2)], paired=True)
    assert port_blob == jax_blob
    o1, o2 = io.BytesIO(), io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(port_blob),
                            make_deinterleave_writer(o1, o2, arg), arg,
                            Timings(), CPU)
    assert o1.getvalue() == r1.read_bytes()
    assert o2.getvalue() == r2.read_bytes()
