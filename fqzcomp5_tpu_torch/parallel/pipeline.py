"""Data-parallel walks over a device mesh.

The counterpart of the JAX package's ``parallel/pipeline.py``.  Every
row of a walk batch is an independent stream (a section, its PACK'd
copy, a STRIPE sub-stream, a model context, a range-coder job), so rows
split over devices without changing a byte:

- a ``Mesh`` holds dp x sp devices, row-major over (dp, sp).  Its
  ``split(n)`` gives contiguous row ranges, one a device.  Contiguous
  ranges keep the row order, so the STRIPE sub-streams that the wave
  driver lays out next to each other land on neighbouring devices: the
  sp axis.  Unlike the JAX package, no padding rows are added.
- a device may stand in a mesh more than once; its ranges then run one
  after another on it (CPU slots in the tests, a one-card host).
- wherever the port takes a ``torch.device`` it takes a ``Mesh`` too
  (engine_cuda's encode walks and decode batches, the adaptive batch's
  pass 2 and pass 3), and a one-device mesh behaves exactly as its
  device.  Each range's tensors are made on that range's device; a
  range's launch never waits on another's.

``Mesh``, ``make_mesh``, ``as_mesh``, ``split_rows`` and ``first_device``
live in the leaf module ``fqzcomp5_tpu_torch.mesh`` (the kernel layer
takes a mesh too) and are re-exported here beside the walk steps.
"""

from __future__ import annotations

import numpy as np
import torch

from fqzcomp5_tpu_torch.mesh import (Mesh, as_mesh, first_device,  # noqa: F401
                                     make_mesh, split_rows)
from fqzcomp5_tpu_torch.ops import rans_cuda
from fqzcomp5_tpu_torch.ops.rans_torch import TF_SHIFT


def _tensor(a) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a)))


def _encode_step(mesh, syms, tab, shift: int, R0=None, nsym=None):
    """Walk a (B, T, 32) batch split over the mesh, each range by
    rans_cuda.encode_walk on its device (all ranges launched before any
    result is read).  Returns CPU tensors (Rf (B, 32) int32, words
    (B, T*32) int16, nwords (B,) int32): stream b's compact words are
    words[b, T*32 - nwords[b]:].  syms: uint8 symbols with nsym, or
    int32 flat indices; tab: (B, S+1) packed tables."""
    syms, tab = _tensor(syms), _tensor(tab)
    parts = []
    for dev, lo, hi in split_rows(mesh, syms.shape[0]):
        r0 = None if R0 is None else _tensor(R0)[lo:hi].to(dev)
        ns = None if nsym is None else _tensor(nsym)[lo:hi].to(dev)
        parts.append(rans_cuda.encode_walk(syms[lo:hi].to(dev),
                                           tab[lo:hi].to(dev), shift, r0, ns))
    return tuple(torch.cat([p[k].cpu() for p in parts]) for k in range(3))


def sharded_encode_step(mesh, syms, tab, shift: int = TF_SHIFT, R0=None,
                        nsym=None):
    """One walk batch over the mesh: (Rf, words, nwords) (_encode_step)."""
    return _encode_step(mesh, syms, tab, shift, R0, nsym)


def training_step(mesh, syms, tab, shift: int = TF_SHIFT, R0=None,
                  nsym=None):
    """sharded_encode_step plus the gathered per-stream sizes (word
    counts, numpy int64): (Rf, words, nwords, sizes)."""
    Rf, words, nwords = _encode_step(mesh, syms, tab, shift, R0, nsym)
    return Rf, words, nwords, nwords.numpy().astype(np.int64)


def shard_map_encode_step(mesh, syms, tab, shift: int = TF_SHIFT, R0=None,
                          nsym=None):
    """training_step plus the payload total: (Rf, words, nwords, sizes,
    total), total = the sum over streams of 2 * nwords + 128 (words and
    final states).  The JAX function adds 128 once a device instead."""
    Rf, words, nwords, sizes = training_step(mesh, syms, tab, shift, R0,
                                             nsym)
    return Rf, words, nwords, sizes, int((2 * sizes + 128).sum())


def _synth_fastq(n: int = 1600, L: int = 100, seed: int = 7) -> bytes:
    """Reads sampled from one random chromosome, with binned qualities."""
    rng = np.random.default_rng(seed)
    chrom = rng.choice(np.frombuffer(b"ACGT", np.uint8), 50000,
                       p=[0.3, 0.2, 0.2, 0.3])
    base = np.clip(40 - (np.arange(L) // 12) * 2, 22, 40)
    off = rng.integers(0, len(chrom) - L, n)
    seq = chrom[off[:, None] + np.arange(L)[None, :]]
    q = np.where(rng.random((n, L)) < 0.03, 11,
                 base + rng.choice([-2, 0, 0, 0, 2], (n, L))) + 33
    return b"".join(b"@r%d\n" % i + seq[i].tobytes() + b"\n+\n"
                    + q[i].astype(np.uint8).tobytes() + b"\n"
                    for i in range(n))


def dryrun_multichip(mesh: Mesh) -> None:
    """Run the wave engine at -1 over `mesh` and on its first device
    alone and require equal archives; decode the archive on the host and
    over the mesh with both table forms and require the source; and hold
    the mesh's walk steps against one device's.  Raises AssertionError
    on any difference."""
    import io

    from fqzcomp5_tpu_torch import cuda_driver, drivers, fastq
    from fqzcomp5_tpu_torch.options import Options
    from fqzcomp5_tpu_torch.ops.rans_torch import build_packed_tables

    data = _synth_fastq()
    arg = Options()
    arg.apply_preset(1)
    arg.blk_size = 24 << 10          # about 7 blocks: a wave of several
    arg.verbose = -1

    def encode(dev) -> bytes:
        out = io.BytesIO()
        parser = fastq.Parser(io.BytesIO(data))
        cuda_driver.encode_stream(cuda_driver._batches(parser, arg.blk_size),
                                  out, arg, drivers.Timings(), dev)
        return out.getvalue()

    sharded = encode(mesh)
    if sharded != encode(mesh.devices[0]):
        raise AssertionError(f"the archive over {mesh} differs from one "
                             "device's")
    res = io.BytesIO()
    drivers.decode_file(io.BytesIO(sharded), drivers.make_fastq_writer(
        res, arg), arg, drivers.Timings())
    if res.getvalue() != data:
        raise AssertionError("the host decode of the mesh's archive differs "
                             "from the source")
    for tables in ("lut", "boundary"):
        res = io.BytesIO()
        cuda_driver.decode_file(io.BytesIO(sharded),
                                drivers.make_fastq_writer(res, arg), arg,
                                drivers.Timings(), mesh, tables=tables)
        if res.getvalue() != data:
            raise AssertionError(f"the decode over {mesh} ({tables} tables) "
                                 "differs from the source")

    rng = np.random.default_rng(1)
    B, T = 2 * mesh.size + 1, 16
    freqs = np.zeros((B, 256), np.uint32)
    freqs[:, :4] = 1024
    tab = build_packed_tables(freqs, TF_SHIFT)
    syms = rng.integers(0, 4, (B, T, 32)).astype(np.int32)
    got = shard_map_encode_step(mesh, syms, tab)
    want = shard_map_encode_step(mesh.devices[0], syms, tab)
    for g, w in zip(got[:4], want[:4]):
        if not np.array_equal(np.asarray(g), np.asarray(w)):
            raise AssertionError(f"the walk step over {mesh} differs from "
                                 "one device's")
    if got[4] != want[4]:
        raise AssertionError("the walk step's totals differ")
