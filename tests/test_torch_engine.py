"""engine_cuda on the CPU against engine_tpu on the CPU.

The port's batched encoders must write the JAX engine's payload bytes
and report its candidate sizes (ties between candidates go by order, so
the sizes must match exactly); its decoders must give back the source,
as the native decoder does.  On the CPU the port's walks are the plain
PyTorch versions; the tests check that they ran.
"""

import numpy as np
import pytest
import torch

from fqzcomp5_tpu import engine_tpu
from fqzcomp5_tpu.codecs import host
from fqzcomp5_tpu.utils import varint
from fqzcomp5_tpu_torch import engine_cuda
from fqzcomp5_tpu_torch.ops import rans_torch

CPU = torch.device("cpu")


def _markov(rng, n, pdom):
    """Bytes 0..3 cycling with probability pdom, else random: strongly
    skewed contexts, for which the native prep may pick order-1 shift
    12."""
    reset = rng.random(n) >= pdom
    reset[0] = True
    pos = np.flatnonzero(reset)
    seg = np.cumsum(reset) - 1
    base = rng.integers(0, 4, len(pos))
    return ((base[seg] + np.arange(n) - pos[seg]) % 4).astype(np.uint8)


def _datas():
    rng = np.random.default_rng(21)
    dna = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5003)
    qual = (np.cumsum(rng.integers(-2, 3, 7001)) % 40 + 35).astype(np.uint8)
    single = np.full(4500, 65, np.uint8)
    noise = rng.integers(0, 256, 6000).astype(np.uint8)  # high entropy
    skew = _markov(rng, 60000, 0.99)
    return [d.tobytes() for d in (dna, qual, single, noise, skew)]


@pytest.fixture(scope="module")
def datas():
    d = _datas()
    shifts = [engine_cuda.o1_prep(x)[2] for x in d]
    assert 10 in shifts and 12 in shifts  # both order-1 shift groups
    return d


@pytest.fixture
def plain_calls(monkeypatch):
    calls = []
    for name in ("encode_walk_ref", "decode_o0_ref", "decode_o1_ref"):
        fn = getattr(rans_torch, name)
        monkeypatch.setattr(
            rans_torch, name,
            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("order", [0, 1])
def test_encode_batch_matches_jax(datas, order, plain_calls):
    port = (engine_cuda.encode_o0_batch_lazy if order == 0
            else engine_cuda.encode_o1_batch_lazy)(datas, CPU)
    jax = (engine_tpu.encode_o0_batch_lazy if order == 0
           else engine_tpu.encode_o1_batch_lazy)(datas)
    assert port.sizes == jax.sizes
    assert port.fetch_all() == jax.fetch_all()
    want = [1, 3]
    assert port.fetch(want) == {i: jax.fetch_all()[i] for i in want}
    assert "encode_walk_ref" in plain_calls


@pytest.mark.parametrize("order", [0, 1])
def test_decode_batch_round_trips(datas, order, plain_calls):
    enc = engine_cuda.encode_o0_batch if order == 0 \
        else engine_cuda.encode_o1_batch
    dec = engine_cuda.decode_o0_batch if order == 0 \
        else engine_cuda.decode_o1_batch
    pays = enc(datas, CPU)
    for d, p in zip(datas, pays):
        framed = bytes([0x04 | order]) + varint.put_u32(len(d)) + p
        assert host.rans_uncompress(framed) == d
    fin = dec(pays, [len(d) for d in datas], CPU, lazy=True)
    assert fin() == datas
    assert f"decode_o{order}_ref" in plain_calls


def test_o1_single_symbol_context_at_shift_12():
    # a context with one symbol at shift 12 stores f = 4096, which wraps
    # to 0 in the u32 s3 table; the decoder must read it as 4096
    rng = np.random.default_rng(5)
    d = _markov(rng, 60000, 0.995)
    pos = rng.integers(0, len(d) - 1, 20)
    d[pos] = 250
    d[pos + 1] = 251
    data = d.tobytes()
    _, freqs, shift = engine_cuda.o1_prep(data)
    assert shift == 12 and freqs[250].max() == 4096
    pay = engine_cuda.encode_o1_batch([data], CPU)
    assert pay == engine_tpu.encode_o1_batch([data])
    assert engine_cuda.decode_o1_batch(pay, [len(data)], CPU) == [data]
    framed = bytes([0x05]) + varint.put_u32(len(data)) + pay[0]
    assert host.rans_uncompress(framed) == data


def test_empty_batches():
    assert engine_cuda.encode_o0_batch_lazy([], CPU).sizes == []
    assert engine_cuda.encode_o1_batch([], CPU) == []
    assert engine_cuda.decode_o0_batch([], [], CPU) == []
    assert engine_cuda.decode_o1_batch([], [], CPU, lazy=True)() == []
