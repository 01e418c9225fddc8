"""Device side of the encode walks: lazy results and the walk entries.

``encode_u8_lazy`` (order-0 symbol planes) and ``encode_flat_lazy``
(order-1 flat index planes) run the walk on the device their tensors
lie on -- the CUDA kernel for a CUDA tensor, the plain version for a CPU
tensor (``rans_cuda.encode_walk`` decides) -- and return a ``LazyFlat``
whose results stay on that device until fetched.
"""

from __future__ import annotations

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import devtimer, rans_cuda


class deferred_walks:
    """Scope in which the wave driver queues walks and winner fetches.

    Kernel launches are already asynchronous, so nothing is held back:
    the first ``LazyFlat.nwords()`` read is the one wait for a batch of
    walks.  The scope stays as cuda_driver's marker of a fused batch."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class LazyFlat:
    """Encode-walk results kept on their device.

    The trial waves need every candidate's compressed size to pick a
    winner, but only the winners' bytes.  ``nwords()`` copies one int32
    per stream to the host; ``fetch(idxs)`` copies only the requested
    streams' compact words, each a slice of the walk's output.

    A walk split over a mesh is one LazyFlat of parts (``join``): part k
    holds rows [base_k, base_k + rows) on its own device.  The parts'
    results never meet on one device: each is copied to the host."""

    def __init__(self, Rf: torch.Tensor, words: torch.Tensor,
                 nwords: torch.Tensor):
        self._parts = [(Rf, words, nwords)]
        self._bases = [0]
        self._nw: np.ndarray | None = None

    @classmethod
    def join(cls, parts: list[LazyFlat]) -> LazyFlat:
        """One LazyFlat of consecutive row ranges, in order."""
        lz = parts[0]
        for p in parts[1:]:
            base = lz._bases[-1] + lz._parts[-1][0].shape[0]
            lz._parts += p._parts
            lz._bases += [base + b for b in p._bases]
        return lz

    def nwords(self) -> np.ndarray:
        """(B,) emitted-word count per stream (payload size is tables +
        128 state bytes + 2 * nwords)."""
        if self._nw is None:
            self._nw = np.concatenate([devtimer.get(nw).astype(np.int64)
                                       for _, _, nw in self._parts])
        return self._nw

    def prefetch(self, idxs) -> None:
        """Nothing to queue: fetch's copy is the only transfer."""

    def fetch(self, idxs) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """idx -> (Rf (32,) uint32, compact words (nwords,) uint16)."""
        sel = [int(i) for i in idxs]
        if not sel:
            return {}
        nw = self.nwords()
        part = np.searchsorted(self._bases, sel, side="right") - 1
        out = {}
        for k, (Rf_d, words, _) in enumerate(self._parts):
            mine = [i for i, p in zip(sel, part) if p == k]
            if not mine:
                continue
            base = self._bases[k]
            cap = words.shape[1]
            flat = torch.cat([words[i - base, cap - int(nw[i]):]
                              for i in mine])
            flat = devtimer.get(flat).view(np.uint16)
            rows = devtimer.put(np.array([i - base for i in mine], np.int64),
                                Rf_d.device)
            Rf = devtimer.get(Rf_d.index_select(0, rows)).view(np.uint32)
            off = 0
            for j, i in enumerate(mine):
                n = int(nw[i])
                out[i] = (Rf[j], flat[off:off + n])
                off += n
        return out

    def fetch_all(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """(Rf, compact words) of every stream, in stream order."""
        B = len(self.nwords())
        got = self.fetch(range(B))
        return [got[i] for i in range(B)]


def encode_u8_lazy(plane: torch.Tensor, nsym: torch.Tensor,
                   tab: torch.Tensor, shift: int,
                   R0: torch.Tensor | None = None) -> LazyFlat:
    """Order-0 walk over a (B, T, 32) uint8 symbol plane: symbol p of
    stream b sits at [b, p // 32, p % 32]; slots at or past nsym[b] are
    no-ops, so their content is never read."""
    return LazyFlat(*rans_cuda.encode_walk(plane, tab, shift, R0, nsym))


def encode_flat_lazy(flat: torch.Tensor, tab: torch.Tensor, shift: int,
                     R0: torch.Tensor | None = None) -> LazyFlat:
    """Walk over a (B, T, 32) int32 plane of flat table indices
    (order-1: ctx * 256 + sym), the sentinel S marking no-op slots."""
    return LazyFlat(*rans_cuda.encode_walk(flat, tab, shift, R0))
