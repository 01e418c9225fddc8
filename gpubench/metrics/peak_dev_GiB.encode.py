"""The largest device memory an encode held (torch.cuda's
max_memory_allocated, reset before each encode), in GiB."""


def read(trace):
    peaks = [t.enc_peak for t in trace.trips if not t.error]
    if not peaks or not max(peaks):
        return None
    return max(peaks) / 2 ** 30
