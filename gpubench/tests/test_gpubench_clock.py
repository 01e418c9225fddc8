"""The clock the program's spans share with torch.profiler (python -m
pytest gpubench/tests -m card on a machine with a CUDA device): the
program stamps its spans with time.time_ns(), and gbench.program_spans
places them on the profile by one offset, which holds where the card's
torch stamps a record_function range on that clock."""

import time

import pytest


@pytest.mark.card
def test_profiler_stamps_ranges_on_the_wall_clock():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time_ns()
        with record_function("clock_probe"):
            (x * 2).sum().item()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "clock_probe"
              and e.device_type() == DeviceType.CPU]
    assert len(starts) == 1
    assert abs(starts[0] - t) < 5_000_000, starts[0] - t
