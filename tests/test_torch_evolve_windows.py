"""The redesigned pass-2 walks of csrc/fqz_evolve.cu as numpy mirrors,
held on the CPU against the plain walks and the JAX package, zero
tolerance.

tiny_warp_kernel walks a TinyModel context 32 steps a round, every lane
taking its (cum, f, tot) from per-symbol ballots and at most one halving
a round; fqz_model_torch.tiny_window_mirror mirrors it.  At 256 slots
evolve_kernel emits runs of the symbol in slot 0 in closed form;
fqz_model_torch.evolve_prefix_mirror mirrors that on top of the running
prefix.  Neither kernel runs here; chip_smoke.py holds the kernels
themselves against the plain walks on the card, on these cases too
(torch_cases.tiny_window_cases / run_window_cases build them for both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqzcomp5_tpu.ops import fqz_model_jax
from fqzcomp5_tpu_torch.ops import fqz_model_torch
from tests import torch_cases


def _jax_equal(cf, tot, want, counts):
    """Mirror (cf, tot) against a JAX (cum, freq, tot) triple on the
    walked steps (the JAX scans leave garbage past each count)."""
    T = cf.shape[1]
    m = np.arange(T)[None, :] < counts[:, None]
    u = cf.view(np.uint32)
    for g, w in zip((u >> 16, u & 0xFFFF, tot.view(np.uint32)), want):
        assert np.array_equal(g[m], np.asarray(w)[:, :T][m])


@pytest.mark.parametrize("name", list(torch_cases.tiny_window_cases()))
def test_tiny_window_mirror_equals_plain_and_jax(name):
    sp, counts, nsym = torch_cases.tiny_window_cases()[name]
    sp = sp.astype(np.uint8)
    counts = counts.astype(np.int32)
    cf, tot = fqz_model_torch.tiny_window_mirror(sp, counts, nsym)
    ref = fqz_model_torch.tiny_evolve_ref(torch.from_numpy(sp),
                                          torch.from_numpy(counts), nsym)
    assert np.array_equal(cf, ref[0].numpy())
    assert np.array_equal(tot, ref[1].numpy())
    want = fqz_model_jax.tiny_evolve(jnp.asarray(sp.astype(np.int32)),
                                     jnp.asarray(counts), nsym=nsym)
    _jax_equal(cf, tot, want, counts)


def test_tiny_halving_cases_reach_every_lane():
    """The halving cases put a first halving at each lane 0-31 of a
    window (the mirror's own rule: pre-bump tot reaching 255)."""
    cases = torch_cases.tiny_window_cases()
    for nsym in (4, 2):
        sp = cases[f"halving_each_lane_nsym{nsym}"][0]
        lanes = set()
        for row in sp:
            pre = nsym + np.cumsum(row < nsym) - (row < nsym)
            lanes.add(int(np.argmax(pre >= 255)) % 32)
        assert lanes == set(range(32))


@pytest.mark.parametrize("name", list(torch_cases.run_window_cases()))
def test_evolve_run_window_mirror_equals_plain_and_jax(name):
    sp, counts, ms = torch_cases.run_window_cases()[name]
    sp = sp.astype(np.uint8)
    counts = counts.astype(np.int32)
    ms = ms.astype(np.int32)
    cf, tot = fqz_model_torch.evolve_prefix_mirror(sp, counts, ms, 256)
    ref = fqz_model_torch.evolve_ref(torch.from_numpy(sp),
                                     torch.from_numpy(counts),
                                     torch.from_numpy(ms), 256)
    assert np.array_equal(cf, ref[0].numpy())
    assert np.array_equal(tot, ref[1].numpy())
    want = fqz_model_jax.evolve(jnp.asarray(sp.astype(np.int32)),
                                jnp.asarray(counts), jnp.asarray(ms),
                                jnp.int32(16), lanes=256)
    _jax_equal(cf, tot, want, counts)


def test_halving_inside_run_case_holds_runs_and_halvings():
    """The run-length rows of the halving case are runs in slot 0 (cum 0)
    almost throughout, with halvings inside the runs, so the closed form
    and its cut are what the case walks."""
    sp, counts, ms = torch_cases.run_window_cases()["halving_inside_run"]
    sp = sp.astype(np.uint8)
    counts = counts.astype(np.int32)
    cf, tot = fqz_model_torch.evolve_prefix_mirror(sp, counts,
                                                   ms.astype(np.int32), 256)
    cf = cf.view(np.uint32)
    walked = np.arange(sp.shape[1])[None, :] < counts[:, None]
    in_slot0 = walked & (cf >> 16 == 0) & (sp == 255)
    assert in_slot0.sum() > 0.9 * walked.sum()
    # a halving inside the run: tot drops while 255 keeps slot 0
    drops = np.flatnonzero(np.diff(tot[0, :counts[0]].astype(np.int64)) < 0)
    assert len(drops) and (cf[0, drops + 1] >> 16 == 0).all()
