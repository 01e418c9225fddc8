"""The idle-union arithmetic, and roofline work counted from the symbols
walked and the bytes produced, never from the tensors' sizes."""

import pytest
import torch

from gbench import roofline, tracing


def test_merge_busy_and_gaps():
    m = tracing.merge([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert m == [(0, 3), (5, 9), (12, 13)]
    assert tracing.busy_in(m, 0, 20) == 8
    assert tracing.busy_in(m, 2, 6) == 2
    assert tracing.gaps_in(m, 0, 20) == [2, 3, 7]
    assert tracing.gaps_in(m, 1, 6) == [2]


def test_encode_walk_work_ignores_padding():
    # a u8 plane padded to T = 1000 steps: only nsym symbols count
    idx = torch.zeros((2, 1000, 32), dtype=torch.uint8)
    tab = torch.zeros((2, 257), dtype=torch.int32)
    nsym = torch.tensor([100, 30], dtype=torch.int32)
    nwords = torch.tensor([7, 3], dtype=torch.int32)
    res = (None, torch.zeros((2, 32000), dtype=torch.int16), nwords)
    syms, other = roofline.work("encode_walk", (idx, tab, 12, None, nsym),
                                res)
    assert int(syms) == 130 and int(other) == 20
    # int32 planes carry their sentinel (the table's last index)
    flat = torch.full((1, 8, 32), 256, dtype=torch.int32)
    flat[0, 0, :5] = 3
    syms, _ = roofline.work("encode_walk", (flat, tab[:1], 12), res)
    assert int(syms) == 5


def test_decode_and_model_work():
    # a decode's symbols from its rows; its bytes read from the archive
    t_real = torch.tensor([3, 9], dtype=torch.int32)
    for walk, args in (("decode_o1", (None, None, None, t_real, 5, 10)),
                       ("decode_o0", (None, None, None, t_real, 5))):
        syms, other = roofline.work(walk, args, (None, None))
        assert int(syms) == 32 * (3 + 5) and other is None
    plane = torch.zeros((3, 50), dtype=torch.uint8)
    counts = torch.tensor([10, 60, 0], dtype=torch.int32)
    syms, other = roofline.work("evolve_128", (plane, counts), None)
    assert int(syms) == 60 and int(other) == 60 * roofline.MODEL_STEP_BYTES
    n = torch.tensor([100, 20], dtype=torch.int32)
    totals = torch.tensor([40, 9], dtype=torch.int32)
    syms, other = roofline.work(
        "rc_encode_walk", (None, None, None, n, None, 4096),
        (None, totals, None))
    assert int(syms) == 120
    assert int(other) == 120 * roofline.MODEL_STEP_BYTES + 49


def test_decodes_of_either_order_read_the_archive_rate():
    seen = tracing.Launches()
    seen.seen = [("decode_o0", "decode", 1000, None),
                 ("decode_bnd_o0", "decode", 500, None),
                 ("decode_o1", "decode", 2000, None),
                 ("encode_walk", "encode", 300, 60)]
    got = seen.totals({0: 0.25, 1: 0.5})
    assert [g["bytes"] for g in got] == [1250, 625, 3000, 360]
    # an order the archive holds no stream of: that launch is not counted
    assert [g["walk"] for g in seen.totals({1: 0.5})] == [
        "decode_o1", "encode_walk"]


def test_least_time_is_the_longer_bound():
    walk = "decode_o0"
    ops = roofline.OPS_PER_STEP[walk] * 10 ** 9 / roofline.INT32_OPS_S
    assert roofline.least_seconds(10 ** 9, 10 ** 6, walk) == pytest.approx(
        ops)
    nb = 10 ** 12
    assert roofline.least_seconds(10, nb, walk) == pytest.approx(
        nb / roofline.HBM_BYTES_S)


def test_roofline_metric_is_least_over_kernel_time():
    from gbench.registry import HERE, reader

    class T:
        launches = [{"span": "encode", "least_s": 0.002},
                    {"span": "decode", "least_s": 1.0}]

        def kernel_us(self, kind):
            return 8000.0 if kind == "encode" else 0.0

    read = reader(HERE + "/metrics", "walk_roofline_pct.encode")
    assert read(T()) == pytest.approx(25.0)
    # nothing walked on the card: nothing to read, never 0
    assert reader(HERE + "/metrics", "walk_roofline_pct.decode")(T()) is None
