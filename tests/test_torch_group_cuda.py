"""Pass 2's device grouping on the card against the host's numpy
grouping, at the size of a -5 encode's families.

Marked ``card``: skips without a CUDA device.  This file imports no JAX,
so on a machine with the card it runs without the tests' conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_group_cuda.py
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu_torch.ops import fqz_model_torch
from fqzcomp5_tpu_torch.ops.adaptive_batch import JOB_OFF


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
    got = fqz_model_torch.group_stream_torch(ctx, qm, torch.device("cuda"))
    want = fqz_model_torch.group_stream(ctx, qm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
