"""Pass 2 on the card against the host's numpy path, at the size of a
-5 encode's families: the device grouping against group_stream, and the
device-resident pass 2 (planes gathered and triples scattered on the
card) against planes built in numpy and walked by the same kernels.

Marked ``card``: skips without a CUDA device.  This file imports no JAX,
so on a machine with the card it runs without the tests' conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_group_cuda.py
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch.ops import adaptive_batch, fqz_model_torch
from fqzcomp5_tpu_torch.ops.adaptive_batch import JOB_OFF
from tests import pass2_ref


def _family(jobs, n, nctx, sym_hi, seed):
    """n events of `jobs` jobs over nctx skewed model ids (a few hot
    contexts, a long tail), symbols below sym_hi as int32."""
    rng = np.random.default_rng(seed)
    mid = np.minimum(rng.zipf(1.2, n) - 1, nctx - 1)
    job = np.sort(rng.integers(0, jobs, n))   # events in job order
    return (job * JOB_OFF + mid, rng.integers(0, sym_hi, n).astype(np.int32))


@pytest.mark.card
@pytest.mark.parametrize("jobs,n,nctx,sym_hi", [
    (1, 3_000_000, 4 ** 12, 4),       # one seq job's k-mer contexts
    (4, 4_000_000, 4 ** 12, 4),       # four jobs: keys past 2^32
    (4, 2_000_000, 70_000, 256),      # byte symbols, qual-sized ids
])
def test_group_stream_torch_on_the_card(jobs, n, nctx, sym_hi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx, qm = _family(jobs, n, nctx, sym_hi, seed=jobs * n + sym_hi)
    dev = torch.device("cuda")
    got = [t.cpu().numpy() for t in fqz_model_torch.group_stream_torch(
        torch.from_numpy(ctx).to(dev), torch.from_numpy(qm).to(dev))]
    want = fqz_model_torch.group_stream(ctx, qm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("jobs,n,nctx,sym_hi,fam", [
    (1, 3_000_000, 4 ** 12, 4, adaptive_batch.F_T4),
    (4, 4_000_000, 4 ** 12, 4, adaptive_batch.F_T4),
    (4, 2_000_000, 70_000, 256, adaptive_batch.F_W256),
    (4, 2_000_000, 70_000, 96, adaptive_batch.F_N128),
])
def test_device_pass2_on_the_card(jobs, n, nctx, sym_hi, fam):
    """The batch's pass 2 kept on the card (one sort, planes gathered,
    triples scattered there) equals the numpy path's cf/tot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx, qm = _family(jobs, n, nctx, sym_hi, seed=jobs * n + sym_hi + fam)
    job = ctx // JOB_OFF
    preps = [(b"", np.full(int((job == j).sum()), fam, np.int8),
              ctx[job == j] % JOB_OFF, qm[job == j], None, (97, 3))
             for j in range(jobs)]
    dev = torch.device("cuda")
    want = pass2_ref.pass2_np(preps, dev)
    got = adaptive_batch.DevTriples(n, dev)
    adaptive_batch._evolve_families(preps, got, dev)
    assert np.array_equal(got.cf.cpu().numpy(), want[0])
    assert np.array_equal(got.tot.cpu().numpy(), want[1])
