"""Whole archives at every preset: the port's wave engine on the CPU (its
plain walks) against ``fqzcomp5_tpu -e tpu`` on the CPU, byte for byte,
and the port's decoder back to the source.

The inputs hold a few hundred reads with some N and lower-case bases, in
16 KB blocks: four blocks, so each section's method learner goes from
its three trial blocks to a locked method within the file, and every
seq and qual section is at least MIN_DEVICE bytes, so the adaptive
candidates take the device path.
"""

import io

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.codecs import host
from fqzcomp5_tpu.drivers import Timings, make_fastq_writer
from fqzcomp5_tpu_torch import cuda_driver
from fqzcomp5_tpu_torch.ops import fqz_model_torch, rc_cuda, rc_torch

CPU = torch.device("cpu")
BLK = 16_000


def _fastq(path, n=600, seed=5):
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGTNacgt"))
    p = [.24, .24, .24, .24, .01, .01, .01, .005, .005]
    recs = []
    for i in range(n):
        L = int(rng.integers(60, 140))
        seq = "".join(bases[rng.choice(9, L, p=p)])
        q = (np.cumsum(rng.integers(-2, 3, L)) % 40 + 35).astype(
            np.uint8).tobytes().decode("latin1")
        recs.append(f"@S.{i} {i}\n{seq}\n+\n{q}\n")
    path.write_text("".join(recs))
    return path


@pytest.fixture
def plain_calls(monkeypatch):
    calls = []
    for mod, name in ((rc_torch, "encode_walk_ref"),
                      (fqz_model_torch, "evolve_ref"),
                      (fqz_model_torch, "tiny_evolve_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


ALL = {"encode_walk_ref", "evolve_ref", "tiny_evolve_ref"}
FQZ = {"encode_walk_ref", "evolve_ref"}


@pytest.mark.parametrize("argv,walks", [
    (["-1"], set()), (["-3"], set()), (["-1", "-q", "1"], set()),
    (["-3", "-s", "0", "-q", "0"], set()),
    (["-5"], ALL), (["-7"], ALL), (["-9"], ALL), ([], ALL),
    (["-1", "-S", "12"], ALL), (["-3", "-Q", "2"], FQZ)])
def test_archive_matches_jax_engine(tmp_path, argv, walks, plain_calls):
    """The rANS presets, every adaptive preset, the default, and the
    -s/-q/-S/-Q overrides (-Q assigns a method number as the qual mask,
    options.py:141-145)."""
    src = _fastq(tmp_path / "in.fq")
    arg, _, _ = parse_args(argv + ["-V"])
    # below the CLI's 1 MB clamp: the learner locks within the file
    arg.blk_size = BLK
    jax_out, port_out = io.BytesIO(), io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), jax_out, arg, Timings())
    cuda_driver.encode_file(str(src), port_out, arg, Timings(), CPU)
    assert port_out.getvalue() == jax_out.getvalue()
    # the adaptive candidates went through the walks' plain versions
    assert set(plain_calls) & ALL == walks
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(port_out.getvalue()),
                            make_fastq_writer(out, arg), arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()


def test_wide_alphabet_archive_matches_jax_engine(tmp_path):
    """-5 on qualities past the 96-symbol envelope: the fqz methods are
    declined, enter the learner's trial as UINT_MAX, and rANS wins --
    the same archive as the JAX engine's."""
    rng = np.random.default_rng(98)
    recs = []
    for i in range(300):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 80)
        qv = (rng.integers(0, 90, 80) + 33).astype(np.uint8)
        qv[::7] = 200
        recs.append(b"@r%d\n" % i + seq.tobytes() + b"\n+\n" + qv.tobytes()
                    + b"\n")
    src = tmp_path / "w.fastq"
    src.write_bytes(b"".join(recs))
    arg, _, _ = parse_args(["-5", "-V"])
    arg.blk_size = BLK
    jax_out, port_out = io.BytesIO(), io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), jax_out, arg, Timings())
    cuda_driver.encode_file(str(src), port_out, arg, Timings(), CPU)
    assert port_out.getvalue() == jax_out.getvalue()
    out = io.BytesIO()
    cuda_driver.decode_file(io.BytesIO(port_out.getvalue()),
                            make_fastq_writer(out, arg), arg, Timings(), CPU)
    assert out.getvalue() == src.read_bytes()


def test_kernel_error_propagates_without_host_reencode(tmp_path,
                                                       monkeypatch):
    """A failing walk in the adaptive path raises out of the encode; no
    host codec re-encodes the sections."""
    src = _fastq(tmp_path / "in.fq", n=200)
    host_calls = []
    for name in ("seq_encode", "fqz_compress"):
        fn = getattr(host, name)
        monkeypatch.setattr(
            host, name,
            lambda *a, _fn=fn, _n=name, **k: host_calls.append(_n)
            or _fn(*a, **k))

    def broken(*a, **k):
        raise RuntimeError("rc encode_walk: CUDA launch failed")
    monkeypatch.setattr(rc_cuda, "encode_walk", broken)
    arg, _, _ = parse_args(["-5", "-V"])
    arg.blk_size = BLK
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_driver.encode_file(str(src), io.BytesIO(), arg, Timings(), CPU)
    assert host_calls == []
