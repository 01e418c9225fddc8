"""The port's device mesh (fqzcomp5_tpu_torch.parallel.pipeline) against
the JAX package's, on the CPU.

Port meshes are made of CPU slots (the same device standing in several
places, its ranges run one after another), the JAX ones of the 8-device
virtual CPU mesh that tests/conftest.py sets up.  A mesh splits the
rows of every walk batch, so every comparison is exact: the walk steps
against the JAX steps, and archives under a mesh against
``fqzcomp5_tpu -e tpu`` without one.
"""

import io

import jax
import numpy as np
import pytest
import torch

from fqzcomp5_tpu import tpu_driver
from fqzcomp5_tpu.cli import parse_args
from fqzcomp5_tpu.drivers import Timings
from fqzcomp5_tpu.ops import rans_jax
from fqzcomp5_tpu.parallel import pipeline as jpipe
from fqzcomp5_tpu_torch import cuda_driver, engine_cuda
from fqzcomp5_tpu_torch.drivers import make_fastq_writer
from fqzcomp5_tpu_torch.ops import adaptive_batch, fqz_model_torch
from fqzcomp5_tpu_torch.ops.rans_torch import build_packed_tables
from fqzcomp5_tpu_torch.parallel import pipeline
from tests.test_torch_adaptive import _flat, _jax_payloads, _rc_case

CPU = torch.device("cpu")
MESHES = {"2x2": (2, 2), "3x1": (3, 1)}


def _mesh(shape):
    dp, sp = MESHES[shape]
    return pipeline.make_mesh([CPU] * (dp * sp), dp=dp, sp=sp)


@pytest.mark.parametrize("n, dp, sp", [(8, None, 1), (8, None, 2),
                                       (8, None, 4), (8, 3, 2), (6, None, 4),
                                       (5, 2, 2), (1, None, 1)])
def test_make_mesh_shape_rules_match_jax(n, dp, sp):
    jdevs = jax.devices("cpu")[:n]
    # device objects of distinct indices show which devices were taken
    tdevs = [torch.device("cuda", i) for i in range(n)]
    jm = jpipe.make_mesh(jdevs, dp=dp, sp=sp)
    tm = pipeline.make_mesh(tdevs, dp=dp, sp=sp)
    assert (tm.dp, tm.sp) == jm.devices.shape
    assert tm.size == jm.devices.size
    pos = {d.id: k for k, d in enumerate(jdevs)}
    assert ([d.index for d in tm.devices]
            == [pos[d.id] for d in jm.devices.reshape(-1)])


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError):
        jpipe.make_mesh(jax.devices("cpu")[:4], dp=3, sp=2)
    with pytest.raises(ValueError):
        pipeline.make_mesh([CPU] * 4, dp=3, sp=2)
    with pytest.raises(ValueError):
        pipeline.make_mesh([CPU] * 1, sp=2)


@pytest.mark.parametrize("n, size, want", [
    (5, 4, [(0, 2), (2, 4), (4, 5)]), (5, 8, [(k, k + 1) for k in range(5)]),
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]), (0, 3, []), (1, 1, [(0, 1)])])
def test_split_gives_contiguous_ranges(n, size, want):
    devs = [torch.device("cuda", i) for i in range(size)]
    got = pipeline.make_mesh(devs).split(n)
    assert [(lo, hi) for _, lo, hi in got] == want
    assert [d.index for d, _, _ in got] == list(range(len(want)))
    assert pipeline.split_rows(CPU, n) == ([(CPU, 0, n)] if n else [])


def _step_inputs(B=5, T=24, seed=3):
    rng = np.random.default_rng(seed)
    syms = np.zeros((B, T, 32), np.int32)
    freqs = np.zeros((B, 256), np.uint32)
    for b in range(B):
        A = [4, 46, 200, 1, 17][b % 5]
        syms[b] = rng.integers(0, A, (T, 32))
        c = np.bincount(syms[b].reshape(-1), minlength=256)
        f = np.where(c > 0, 1 + c * (4096 - A) // c.sum(), 0)
        f[f.argmax()] += 4096 - f.sum()
        freqs[b] = f
    return syms, freqs


def _jax_rows(mesh_n, syms, freqs, fn):
    """JAX's step on a mesh of mesh_n devices; rows padded to a multiple
    of it (as the JAX package pads), the padding dropped."""
    B = syms.shape[0]
    pad = (-B) % mesh_n
    sp = np.concatenate([syms, np.zeros((pad,) + syms.shape[1:], np.int32)])
    fp = np.concatenate([freqs, np.repeat(freqs[:1], pad, axis=0)])
    mesh = jpipe.make_mesh(jax.devices("cpu")[:mesh_n], dp=mesh_n // 2, sp=2)
    out = fn(mesh, sp, rans_jax.build_enc_tables(fp, rans_jax.TF_SHIFT))
    Rf, words, mask = (np.asarray(x)[:B] for x in out[:3])
    rows = [np.frombuffer(rans_jax.assemble_o0_stream(
        Rf[b], words[b], mask[b])[128:], "<u2") for b in range(B)]
    return Rf.astype(np.uint32), rows, np.asarray(out[3])[:B]


@pytest.mark.parametrize("slots", [4, 8])
def test_encode_steps_match_jax(slots):
    syms, freqs = _step_inputs()
    tab = build_packed_tables(freqs, rans_jax.TF_SHIFT)
    mesh = pipeline.make_mesh([CPU] * slots, sp=2)
    Rf_j, rows_j, sizes_j = _jax_rows(slots, syms, freqs,
                                      jpipe.sharded_encode_step)
    sizes_jm = _jax_rows(slots, syms, freqs, jpipe.shard_map_encode_step)[2]
    for step in (pipeline.sharded_encode_step, pipeline.training_step,
                 pipeline.shard_map_encode_step):
        out = step(mesh, syms, tab)
        Rf, words, nwords = out[:3]
        assert words.device == CPU
        np.testing.assert_array_equal(Rf.numpy().view(np.uint32), Rf_j)
        np.testing.assert_array_equal(nwords.numpy(), sizes_j)
        cap = words.shape[1]
        w = words.numpy().view(np.uint16)
        for b, want in enumerate(rows_j):
            np.testing.assert_array_equal(w[b, cap - nwords[b]:], want)
        if step is not pipeline.sharded_encode_step:
            np.testing.assert_array_equal(out[3], sizes_jm)
        if step is pipeline.shard_map_encode_step:
            assert out[4] == int((2 * sizes_j.astype(np.int64) + 128).sum())


def test_lazy_flat_parts_fetch_any_rows():
    datas = [np.random.default_rng(k).choice(
        np.frombuffer(b"ACGTN", np.uint8), 300 + 97 * k).tobytes()
        for k in range(7)]
    one = engine_cuda.encode_o0_batch_lazy(datas, CPU)
    lz = engine_cuda.encode_o0_batch_lazy(datas, _mesh("3x1"))
    assert lz.sizes == one.sizes
    assert lz.fetch([6, 0, 3]) == one.fetch([0, 3, 6])
    assert lz.fetch_all() == one.fetch_all()
    for mesh in (_mesh("2x2"), _mesh("3x1")):
        assert (engine_cuda.encode_o1_batch(datas, mesh)
                == engine_cuda.encode_o1_batch(datas, CPU))


@pytest.mark.parametrize("tables", ["lut", "boundary"])
def test_decode_batches_over_a_mesh(tables):
    rng = np.random.default_rng(21)
    datas = [rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                        int(rng.integers(100, 3000))).tobytes()
             for _ in range(5)]
    szs = [len(d) for d in datas]
    p0 = engine_cuda.encode_o0_batch(datas, CPU)
    p1 = engine_cuda.encode_o1_batch(datas, CPU)
    for mesh in (_mesh("2x2"), _mesh("3x1")):
        assert engine_cuda.decode_o0_batch(p0, szs, mesh,
                                           tables=tables) == datas
        fin = engine_cuda.decode_o1_batch(p1, szs, mesh, lazy=True,
                                          tables=tables)
        assert fin() == datas


def test_pass2_and_pass3_over_a_mesh(monkeypatch):
    """evolve_grouped's bucket rows and rc_walk's streams split over a
    mesh: the triples and payloads equal one device's; rc_walk in short
    chunks, with ragged lengths so that ranges end at different chunks."""
    rng = np.random.default_rng(9)
    ctx = rng.integers(0, 300, 20000) ** 2 % 977
    qm = rng.integers(0, 40, 20000)
    want = fqz_model_torch.triples_for_stream(ctx, qm, 40, device=CPU)
    got = fqz_model_torch.triples_for_stream(ctx, qm, 40,
                                             device=_mesh("3x1"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    cum, freq, tot = _rc_case(1, 5, 1500)
    lens = np.array([1500, 1100, 1499, 0, 1], np.int64)
    cf, tt, starts = _flat(cum, freq, tot, lens)
    monkeypatch.setattr(adaptive_batch, "CHUNK_T", 256)
    want = _jax_payloads(cum, freq, tot, lens)
    for mesh in (_mesh("2x2"), _mesh("3x1")):
        assert adaptive_batch.rc_walk(cf, tt, starts, lens, mesh) == want


def _fastq(path, n=700, L=100, seed=4):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes()
        q = (np.cumsum(rng.integers(-2, 3, L)) % 40 + 35).astype(np.uint8)
        recs.append(b"@m%d\n" % i + s + b"\n+\n" + q.tobytes() + b"\n")
    data = b"".join(recs)
    path.write_bytes(data)
    return data


@pytest.mark.parametrize("preset, shape", [("-1", "2x2"), ("-1", "3x1"),
                                           ("-5", "2x2"), ("-5", "3x1")])
def test_archive_under_a_mesh_matches_tpu_engine(tmp_path, preset, shape):
    """Fixed-length reads (STRIPE runs) in 16 KB blocks: the archive
    under a mesh equals -e tpu's without one, and decodes back over the
    mesh with both table forms."""
    src = tmp_path / "in.fastq"
    data = _fastq(src)
    arg, _, _ = parse_args([preset, "-V"])
    arg.blk_size = 16_000
    want = io.BytesIO()
    tpu_driver.encode_file_tpu(str(src), want, arg, Timings())
    mesh = _mesh(shape)
    got = io.BytesIO()
    cuda_driver.encode_file(str(src), got, arg, cuda_driver.Timings(), mesh)
    assert got.getvalue() == want.getvalue()
    for tables in ("lut", "boundary"):
        got.seek(0)
        out = io.BytesIO()
        cuda_driver.decode_file(got, make_fastq_writer(out, arg), arg,
                                cuda_driver.Timings(), mesh, tables=tables)
        assert out.getvalue() == data


def test_dryrun_multichip_on_four_slots():
    pipeline.dryrun_multichip(_mesh("2x2"))
