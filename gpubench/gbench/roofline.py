"""The yardstick of the kernels: the card's peaks, and each walk's work
counted from the algorithm, never from the size of the tensors that a
layout happens to use.

A walk's least time is the larger of its bytes over the memory rate
and its integer operations over the integer rate.  Bytes: every symbol
it walks, 1 byte, read or written once, plus the compressed bytes it
writes (encoders: the words each lane reports) or reads (decoders: the
archive's compressed bytes a symbol of that order, ``DECODE_ORDER``,
from its streams, the same rule for every decode walk) once; a model
walk writes each step's (cumulative frequency, frequency, total) as
three 16-bit values, and the range coder reads them.  Operations:
OPS_PER_STEP times the symbols walked.  The counts reduce the launch's
tensors on the device, so they are taken outside the measured window
(window.Run.tally).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT32_OPS_S = 16.7e12     # 132 SMs x 64 int32 lanes x 1.98 GHz boost clock
MODEL_STEP_BYTES = 6      # one model step's (cum, freq, total), 16 bits each

# integer operations per walked symbol, counted from each walk's
# arithmetic (index math and loop control left out)
OPS_PER_STEP = {"encode_walk": 8, "decode_o0": 7, "decode_o1": 7,
                "decode_bnd_o0": 7, "decode_dense_o1": 8, "evolve_128": 10,
                "evolve_256": 10, "tiny_evolve": 6, "rc_encode_walk": 12}

# the rANS order of each decode walk's streams
DECODE_ORDER = {"decode_o0": 0, "decode_bnd_o0": 0, "decode_o1": 1,
                "decode_dense_o1": 1}

# (module, attribute) of the program's kernel wrappers, by walk
WRAPPERS = {
    "encode_walk": ("fqzcomp5_tpu_torch.ops.rans_cuda", "encode_walk"),
    "decode_o0": ("fqzcomp5_tpu_torch.ops.rans_cuda_dec", "decode_o0"),
    "decode_o1": ("fqzcomp5_tpu_torch.ops.rans_cuda_dec", "decode_o1"),
    "decode_bnd_o0": ("fqzcomp5_tpu_torch.ops.rans_cuda_bnd",
                      "decode_bnd_o0"),
    "decode_dense_o1": ("fqzcomp5_tpu_torch.ops.rans_cuda_bnd",
                        "decode_dense_o1"),
    "evolve_128": ("fqzcomp5_tpu_torch.ops.model_cuda", "evolve_128"),
    "evolve_256": ("fqzcomp5_tpu_torch.ops.model_cuda", "evolve_256"),
    "tiny_evolve": ("fqzcomp5_tpu_torch.ops.model_cuda", "tiny_evolve"),
    "rc_encode_walk": ("fqzcomp5_tpu_torch.ops.rc_cuda", "encode_walk"),
}


def least_seconds(symbols: int, nbytes: int, walk: str) -> float:
    """The least time the card could take for a walk of this work."""
    return max(nbytes / HBM_BYTES_S,
               OPS_PER_STEP[walk] * symbols / INT32_OPS_S)


def work(walk: str, args: tuple, result) -> tuple:
    """(symbols, other bytes) of one launch, as tensors or ints still to
    be read: symbols walked, and the compressed bytes (or model steps'
    bytes) written; None for a decode's bytes read, which come from the
    archive (DECODE_ORDER).  Reduces the launch's tensors on its device."""
    import torch

    if walk == "encode_walk":
        idx, tab = args[0], args[1]
        nsym = args[4] if len(args) > 4 else None
        syms = (nsym.sum() if nsym is not None
                else (idx != tab.shape[1] - 1).sum())
        return syms, 2 * result[2].sum()            # 16-bit words written
    if walk in DECODE_ORDER:
        k = 4 if walk == "decode_bnd_o0" else 3
        t_real, T = args[k], args[k + 1]
        return 32 * t_real.clamp(0, T).sum(), None
    if walk == "rc_encode_walk":
        n, totals = args[3], result[1]
        return n.sum(), MODEL_STEP_BYTES * n.sum() + totals.sum()
    plane, counts = args[0], args[1]                 # model walks
    steps = counts.to(torch.int64).clamp(0, plane.shape[1]).sum()
    return steps, MODEL_STEP_BYTES * steps
