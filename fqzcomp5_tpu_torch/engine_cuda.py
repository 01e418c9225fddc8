"""rANS engine of the port: device walks, host table prep and framing.

Produces the same rANS 32x16 payloads as the JAX package's wave engine
(``fqzcomp5_tpu/engine_tpu.py``) and the native codec.  The host (the
native library's prep functions) builds and parses the frequency tables
and frames the bytes; the O(n) state walks run on a torch device:
the CUDA kernels for ``torch.device("cuda")``, their plain versions for
the CPU.

Layout recap (rANS_static32x16pr.c):
- order-0: symbol p -> lane p%32 at step p//32; the <32-byte remainder
  maps to lanes 0..rem-1 of one more, partial step (its other lanes are
  no-ops).
- order-1: lane z owns the contiguous chunk [z*isz, (z+1)*isz); pairs
  are (ctx = previous byte, sym = byte), each chunk's first byte coded
  with ctx 0; the tail past 32*isz belongs to lane 31 and is walked on
  the host before the encode walk and after the decode walk.

Decode walks read one of two table forms (``tables=``): "lut", the s3
LUTs of the native dec prep (``rans_cuda_dec``), or "boundary", the
boundary tables the JAX engine's FQZ5_DEC_V3 route builds from them
(``rans_bnd_torch``, ``rans_cuda_bnd``): order-0 S-entry tables, and
dense order-1 tables for each shift group whose alphabet has 1 to 64
symbols; a wider group walks its s3 LUTs, as the JAX route takes its
scan there.

Every batch entry takes a ``mesh.Mesh`` in place of a device: its
streams (rows) split into contiguous ranges, one a mesh device, each
walked on its device, and the results meet on the host.
The bytes do not change.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fqzcomp5_tpu_torch.codecs import native
from fqzcomp5_tpu_torch.ops import (backend, devtimer, rans_bnd_torch,
                                    rans_cuda_bnd, rans_cuda_dec)
from fqzcomp5_tpu_torch.ops.rans_torch import (MASK12, RANS_L, TF_SHIFT,
                                               tables_from_numpy)
from fqzcomp5_tpu_torch.mesh import Mesh, split_rows

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)

_NOP_O1 = 256 * 256    # sentinel flat index (order-1 tables: 65537 rows)
MAX_WALK_BYTES = (1 << 31) - 1   # a decode walk's stream: T * 32 in an int


def _lib():
    L = native.lib()
    if not hasattr(L, "_torch_prep_registered"):
        L.fqz5_rans_o0_prep.restype = ctypes.c_int64
        L.fqz5_rans_o0_prep.argtypes = [
            _u8p, ctypes.c_uint32, _u8p, ctypes.c_uint32, _u32p]
        L.fqz5_rans_o0_dec_prep.restype = ctypes.c_int64
        L.fqz5_rans_o0_dec_prep.argtypes = [_u8p, ctypes.c_uint32, _u32p]
        L.fqz5_rans_o1_prep.restype = ctypes.c_int64
        L.fqz5_rans_o1_prep.argtypes = [
            _u8p, ctypes.c_uint32, ctypes.c_int, _u8p, ctypes.c_uint32,
            _u32p, ctypes.POINTER(ctypes.c_int)]
        L.fqz5_rans_o1_dec_prep.restype = ctypes.c_int64
        L.fqz5_rans_o1_dec_prep.argtypes = [
            _u8p, ctypes.c_uint32, _u32p, ctypes.POINTER(ctypes.c_int)]
        L._torch_prep_registered = True
    return L


def _ptr(arr):
    return arr.ctypes.data_as(_u8p)


# ---------------------------------------------------------------------
# host table prep

def o0_prep(data: bytes):
    """(serialized table, freqs (256,) normalised to 1<<12)."""
    L = _lib()
    arr = np.frombuffer(data, np.uint8)
    tab = np.empty(2048, np.uint8)
    freqs = np.empty(256, np.uint32)
    n = L.fqz5_rans_o0_prep(_ptr(arr), len(data), _ptr(tab), 2048,
                            freqs.ctypes.data_as(_u32p))
    if n < 0:
        raise ValueError("o0 prep failed")
    return tab[:n].tobytes(), freqs


def o1_prep(data: bytes, nway: int = 32):
    """(serialized table, freqs (256, 256), shift 10 or 12)."""
    L = _lib()
    arr = np.frombuffer(data, np.uint8)
    cap = 257 * 257 * 3 + 1024
    tab = np.empty(cap, np.uint8)
    freqs = np.empty(256 * 256, np.uint32)
    shift = ctypes.c_int(0)
    n = L.fqz5_rans_o1_prep(_ptr(arr), len(data), nway, _ptr(tab), cap,
                            freqs.ctypes.data_as(_u32p),
                            ctypes.byref(shift))
    if n < 0:
        raise ValueError("o1 prep failed")
    return tab[:n].tobytes(), freqs.reshape(256, 256), shift.value


def _assemble_payload(head: bytes, Rf: np.ndarray, cwords: np.ndarray,
                      tail: bytes = b"") -> bytes:
    """head + 32 final states + the compact word stream (+ tail)."""
    return (head + Rf.astype("<u4").tobytes()
            + cwords.astype("<u2").tobytes() + tail)


def _to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return devtimer.put(arr, device)


# ---------------------------------------------------------------------
# batched encode

class _LazyO0:
    """Order-0 encode of many streams in one walk.  `sizes` holds every
    stream's payload length (tables + 128 state bytes + 2*nwords, one
    int32 copied back per stream); fetch(idxs) copies back only the
    requested winners' words."""

    def __init__(self, datas: list[bytes], device: torch.device | Mesh):
        self._sizes: list[int] | None = None
        self._tabs: list[bytes] = []
        self._lz = None
        B = len(datas)
        if B == 0:
            self._sizes = []
            return
        freq_rows = []
        lens = np.array([len(d) for d in datas], np.int32)
        for d in datas:
            tab, freqs = o0_prep(d)
            self._tabs.append(tab)
            freq_rows.append(freqs)
        Tmax = max(1, int((lens.max() + 31) // 32))
        # slots past each stream's length are no-ops (nsym), so the pad
        # needs no fill
        plane = np.empty((B, Tmax * 32), np.uint8)
        for b, d in enumerate(datas):
            plane[b, :len(d)] = np.frombuffer(d, np.uint8)
        plane = plane.reshape(B, Tmax, 32)
        freqs = np.stack(freq_rows)
        devtimer.count("walk_symbols/encode_walk", int(lens.sum()))
        self._lz = backend.LazyFlat.join([
            backend.encode_u8_lazy(
                _to(plane[lo:hi], dev), _to(lens[lo:hi], dev),
                tables_from_numpy(freqs[lo:hi], "freqs", shift=TF_SHIFT,
                                  device=dev), TF_SHIFT)
            for dev, lo, hi in split_rows(device, B)])

    @property
    def sizes(self) -> list[int]:
        """Payload length per stream; the first read waits for the walk."""
        if self._sizes is None:
            nw = self._lz.nwords()
            self._sizes = [len(self._tabs[b]) + 128 + 2 * int(nw[b])
                           for b in range(len(self._tabs))]
        return self._sizes

    def prefetch(self, idxs) -> None:
        if self._lz is not None:
            self._lz.prefetch(idxs)

    def fetch(self, idxs) -> dict[int, bytes]:
        if self._lz is None:
            return {}
        rows = self._lz.fetch(idxs)
        with devtimer.span("prep/payload"):
            return {i: _assemble_payload(self._tabs[i], *rows[i])
                    for i in rows}

    def fetch_all(self) -> list[bytes]:
        if self._lz is None:
            return []
        rows = self._lz.fetch_all()
        with devtimer.span("prep/payload"):
            return [_assemble_payload(self._tabs[b], *row)
                    for b, row in enumerate(rows)]


def encode_o0_batch_lazy(datas: list[bytes],
                         device: torch.device | Mesh) -> _LazyO0:
    return _LazyO0(datas, device)


def encode_o0_batch(datas: list[bytes],
                    device: torch.device | Mesh) -> list[bytes]:
    """rans_compress_O0_32x16 for many streams in one walk."""
    return _LazyO0(datas, device).fetch_all()


def _lane31_tail(arr: np.ndarray, freqs: np.ndarray, shift: int):
    """Host walk of lane 31's tail (the bytes past 32*isz, encoded
    first).  Builds encoder entries only for the (ctx, sym) pairs the
    tail touches.  Returns (R31 seed for the device walk, tail words in
    emission order)."""
    n = len(arr)
    lo = 32 * (n // 32) - 1
    R31 = RANS_L
    tail_words: list[int] = []
    if n - 1 <= lo:
        return R31, tail_words
    ctxs = arr[lo:n - 1].astype(np.int64)
    syms = arr[lo + 1:n].astype(np.int64)
    cs = np.cumsum(freqs.astype(np.uint64), axis=-1)
    f = freqs[ctxs, syms].astype(np.uint64)
    start = cs[ctxs, syms] - f
    x_max = (((RANS_L >> shift) << 16) * f - 1).astype(np.int64)
    cmpl = ((1 << shift) - f).astype(np.int64)
    big = f >= 2
    fg = np.maximum(f, 1).astype(np.float64)
    sh = np.ceil(np.log2(fg)).astype(np.uint64)
    sh = np.where((np.uint64(1) << sh) < f, sh + 1, sh)
    rcp = np.where(
        big,
        ((np.uint64(1) << (sh + np.uint64(31))) + f
         - np.uint64(1)) // np.maximum(f, 1),
        np.uint64(0xFFFFFFFF)).astype(np.int64)
    rsh = np.where(big, sh - 1, 0).astype(np.int64)
    bias = np.where(big, start, start + (1 << shift) - 1).astype(np.int64)
    for k in range(len(ctxs) - 1, -1, -1):
        if R31 > int(x_max[k]):
            tail_words.append(R31 & 0xFFFF)
            R31 >>= 16
        q = (R31 * int(rcp[k])) >> (32 + int(rsh[k]))
        R31 = (R31 + int(bias[k]) + q * int(cmpl[k])) & 0xFFFFFFFF
    return R31, tail_words


class _LazyO1:
    """Order-1 encode of many streams (see _LazyO0): streams group by
    their frequency shift (10 or 12), one walk per group.  Every stream
    walks on the device, whatever its alphabet."""

    def __init__(self, datas: list[bytes], device: torch.device | Mesh):
        self._sizes: list[int] | None = None
        # per shift group: (idxs, LazyFlat, {i: head}, {i: tail bytes})
        self._groups: list[tuple] = []
        self._B = len(datas)
        if not datas:
            self._sizes = []
            return
        preps = [o1_prep(d) for d in datas]
        for shift in (10, 12):
            idxs = [i for i, p in enumerate(preps) if p[2] == shift]
            if idxs:
                self._build_group(datas, idxs, preps, shift, device)

    def _build_group(self, datas, idxs, preps, shift, device) -> None:
        G = len(idxs)
        R0 = np.full((G, 32), RANS_L, np.uint32)
        tailbs = {}
        iszs = [len(datas[i]) // 32 for i in idxs]
        with devtimer.span("prep/payload"):
            for g, i in enumerate(idxs):
                R0[g, 31], tail = _lane31_tail(
                    np.frombuffer(datas[i], np.uint8), preps[i][1], shift)
                tailbs[i] = np.array(tail[::-1], "<u2").tobytes()
        Tmax = max(1, max(iszs))
        with devtimer.span("prep/o1_plane"):
            flat = np.empty((G, Tmax, 32), np.int32)
            for g, i in enumerate(idxs):
                isz = iszs[g]
                arr = np.frombuffer(datas[i], np.uint8)
                chunks = arr[:32 * isz].reshape(32, isz).astype(np.int32)
                flat[g, 0] = chunks.T[0]  # ctx 0
                flat[g, 1:isz] = chunks.T[:-1] * 256 + chunks.T[1:]
                flat[g, isz:] = _NOP_O1
        freqs = np.stack([preps[i][1] for i in idxs])  # (G, 256, 256)
        R0 = R0.view(np.int32)
        # the plane's slots that are not the sentinel
        devtimer.count("walk_symbols/encode_walk", 32 * sum(iszs))
        lz = backend.LazyFlat.join([
            backend.encode_flat_lazy(
                _to(flat[lo:hi], dev),
                tables_from_numpy(freqs[lo:hi], "freqs", shift=shift,
                                  device=dev),
                shift, R0=_to(R0[lo:hi], dev))
            for dev, lo, hi in split_rows(device, G)])
        heads = {i: preps[i][0] for i in idxs}
        self._groups.append((idxs, lz, heads, tailbs))

    @property
    def sizes(self) -> list[int]:
        """Payload length per stream; the first read waits for the walks."""
        if self._sizes is None:
            sz = [0] * self._B
            for idxs, lz, heads, tailbs in self._groups:
                nw = lz.nwords()
                for g, i in enumerate(idxs):
                    sz[i] = (len(heads[i]) + 128 + 2 * int(nw[g])
                             + len(tailbs[i]))
            self._sizes = sz
        return self._sizes

    def prefetch(self, want) -> None:
        for idxs, lz, _heads, _tailbs in self._groups:
            gpos = {i: g for g, i in enumerate(idxs)}
            sub = [gpos[i] for i in want if i in gpos]
            if sub:
                lz.prefetch(sub)

    def fetch(self, want) -> dict[int, bytes]:
        out = {}
        for idxs, lz, heads, tailbs in self._groups:
            gpos = {i: g for g, i in enumerate(idxs)}
            sub = [i for i in want if i in gpos]
            if not sub:
                continue
            rows = lz.fetch([gpos[i] for i in sub])
            with devtimer.span("prep/payload"):
                for i in sub:
                    out[i] = _assemble_payload(heads[i], *rows[gpos[i]],
                                               tail=tailbs[i])
        return out

    def fetch_all(self) -> list[bytes]:
        got = self.fetch(range(self._B))
        return [got[i] for i in range(self._B)]


def encode_o1_batch_lazy(datas: list[bytes],
                         device: torch.device | Mesh) -> _LazyO1:
    return _LazyO1(datas, device)


def encode_o1_batch(datas: list[bytes],
                    device: torch.device | Mesh) -> list[bytes]:
    """rans_compress_O1_32x16 for many streams (one walk per shift)."""
    return _LazyO1(datas, device).fetch_all()


# ---------------------------------------------------------------------
# batched decode

def _word_rows(bodies) -> tuple[np.ndarray, np.ndarray]:
    """(R0 (B, 32) uint32 flush states, words (B, Wmax) uint16 rows,
    zero-padded, Wmax >= 1) from payload bodies (after the tables)."""
    B = len(bodies)
    Wmax = max(max((len(x) - 128 + 1) // 2 for x in bodies), 1)
    words = np.zeros((B, Wmax), np.uint16)
    R0 = np.empty((B, 32), np.uint32)
    for b, body in enumerate(bodies):
        R0[b] = body[:128].copy().view("<u4")
        wb = body[128:]
        if len(wb) & 1:
            wb = np.concatenate([wb, np.zeros(1, np.uint8)])
        w16 = wb.copy().view("<u2")
        words[b, :len(w16)] = w16
    return R0, words


def _check_tables(tables: str, out_szs: list[int]) -> None:
    if tables not in ("lut", "boundary"):
        raise ValueError(f"unknown decode tables {tables!r}")
    # the walks count a stream's symbols in 31 bits; a larger size comes
    # only from a corrupt archive
    if out_szs and max(out_szs) > MAX_WALK_BYTES:
        raise ValueError(f"decode: a {max(out_szs)}-byte rANS stream is "
                         f"beyond the walks' {MAX_WALK_BYTES} bytes")


def decode_o0_batch(payloads: list[bytes], out_szs: list[int],
                    device: torch.device | Mesh, *, lazy: bool = False,
                    tables: str = "lut"):
    """Batched order-0 decode over the given table form ("lut" or
    "boundary").  With lazy=True, returns a zero-argument finisher: the
    walk is launched now, and the finisher copies the symbols back and
    decodes the <32-byte remainders on the host (from the s3 LUTs).
    decode_o0_batch.calls counts the batches that reach a walk."""
    _check_tables(tables, out_szs)
    L = _lib()
    B = len(payloads)
    if B == 0:
        return (lambda: []) if lazy else []
    decode_o0_batch.calls += 1
    s3s = np.empty((B, 1 << TF_SHIFT), np.uint32)
    bodies = []
    for b, p in enumerate(payloads):
        arr = np.frombuffer(p, np.uint8)
        used = L.fqz5_rans_o0_dec_prep(_ptr(arr), len(arr),
                                       s3s[b].ctypes.data_as(_u32p))
        if used < 0:
            raise ValueError("o0 dec prep failed")
        bodies.append(arr[used:])
    R0, words = _word_rows(bodies)
    t_real = np.array([sz // 32 for sz in out_szs], np.int32)
    Tmax = max(int(t_real.max()), 1)
    words, R0 = words.view(np.int16), R0.view(np.int32)
    devtimer.count("walk_symbols/decode_bnd_o0" if tables == "boundary"
                   else "walk_symbols/decode_o0", 32 * int(t_real.sum()))
    if tables == "boundary":
        tab, f0, S, packed = rans_bnd_torch.o0_tables(s3s)
    parts = []   # (syms, Rf) of each row range, on its device
    for dev, lo, hi in split_rows(device, B):
        args = (_to(words[lo:hi], dev), _to(R0[lo:hi], dev))
        if tables == "boundary":
            parts.append(rans_cuda_bnd.decode_bnd_o0(
                *args, _to(tab[lo:hi], dev), _to(f0[lo:hi], dev),
                _to(t_real[lo:hi], dev), Tmax, S, packed=packed)[:2])
        else:
            parts.append(rans_cuda_dec.decode_o0(
                *args, tables_from_numpy(s3s[lo:hi], "s3", device=dev),
                _to(t_real[lo:hi], dev), Tmax))

    def _finish():
        syms = np.concatenate([devtimer.get(p[0]) for p in parts])
        Rf = np.concatenate([devtimer.get(p[1])
                             for p in parts]).view(np.uint32)
        out = []
        for b, sz in enumerate(out_szs):
            full = syms[b, :sz // 32].reshape(-1)
            rem = sz - (sz // 32) * 32
            if rem:
                tail = (s3s[b][Rf[b, :rem] & MASK12] & 0xFF).astype(np.uint8)
                full = np.concatenate([full, tail])
            out.append(full[:sz].tobytes())
        return out

    return _finish if lazy else _finish()


def decode_o1_batch(payloads: list[bytes], out_szs: list[int],
                    device: torch.device | Mesh, *, lazy: bool = False,
                    tables: str = "lut"):
    """Batched order-1 decode (lazy, tables: see decode_o0_batch).
    Streams group by shift.  A "lut" group uploads its full s3 tables
    (256 << shift u32 per stream); a "boundary" group whose alphabet has
    1 to 64 symbols uploads dense tables (4*A1*(A+1) bytes per stream),
    and a wider one its s3 tables."""
    _check_tables(tables, out_szs)
    L = _lib()
    B = len(payloads)
    if B == 0:
        return (lambda: []) if lazy else []
    decode_o1_batch.calls += 1
    parsed = []
    for p in payloads:
        arr = np.frombuffer(p, np.uint8)
        shift_c = ctypes.c_int(0)
        s3 = np.empty(256 << 12, np.uint32)
        used = L.fqz5_rans_o1_dec_prep(_ptr(arr), len(arr),
                                       s3.ctypes.data_as(_u32p),
                                       ctypes.byref(shift_c))
        if used < 0:
            raise ValueError("o1 dec prep failed")
        parsed.append((shift_c.value, s3[:256 << shift_c.value],
                       arr[used:]))

    groups = []   # (shift, idxs, words, s3s, device results)
    for shift in (10, 12):
        idxs = [i for i, p in enumerate(parsed) if p[0] == shift]
        if not idxs:
            continue
        s3s = np.stack([parsed[i][1] for i in idxs])
        R0, words = _word_rows([parsed[i][2] for i in idxs])
        t_real = np.array([out_szs[i] // 32 for i in idxs], np.int32)
        Tmax = max(int(t_real.max()), 1)
        freqs = (rans_bnd_torch.freqs_from_s3(s3s, shift)
                 if tables == "boundary" else None)
        A = 0 if freqs is None else int(freqs.any(axis=(0, 1)).sum())
        dense = 0 < A <= rans_bnd_torch.DENSE_MAX_A
        if dense:
            tab, alphabet, A, A1, last0 = \
                rans_bnd_torch.build_o1_dense_tables(freqs, shift)
        devtimer.count("walk_symbols/decode_dense_o1" if dense
                       else "walk_symbols/decode_o1", 32 * int(t_real.sum()))
        parts = []   # (syms, Rf, ptrf) of each row range, on its device
        for dev, lo, hi in split_rows(device, len(idxs)):
            args = (_to(words[lo:hi].view(np.int16), dev),
                    _to(R0[lo:hi].view(np.int32), dev))
            if dense:
                dsyms, Rf_d, ptrf_d = rans_cuda_bnd.decode_dense_o1(
                    *args, _to(tab[lo:hi], dev), _to(t_real[lo:hi], dev),
                    Tmax, shift, A, A1, last0)
                # dense indices back to bytes
                alpha = _to(alphabet.astype(np.uint8), dev)
                parts.append((alpha[dsyms.to(torch.int32)], Rf_d, ptrf_d))
            else:
                parts.append(rans_cuda_dec.decode_o1(
                    *args, tables_from_numpy(s3s[lo:hi], "s3", device=dev),
                    _to(t_real[lo:hi], dev), Tmax, shift))
        groups.append((shift, idxs, words, s3s, parts))

    def _finish():
        out = [b""] * B
        for shift, idxs, words, s3s, parts in groups:
            syms, Rf, ptrf = (np.concatenate([devtimer.get(p[k])
                                              for p in parts])
                              for k in range(3))
            Rf = Rf.view(np.uint32)
            tot = 1 << shift
            mask = tot - 1
            for g, i in enumerate(idxs):
                sz = out_szs[i]
                isz = sz // 32
                res = syms[g, :isz].T.reshape(-1)
                rem = sz - 32 * isz
                if rem:
                    # lane 31 continues on the host
                    R = int(Rf[g, 31])
                    ptr = int(ptrf[g])
                    last = int(res[-1]) if isz else 0
                    tail = np.empty(rem, np.uint8)
                    wrow = words[g]
                    for k in range(rem):
                        S = int(s3s[g][last * tot + (R & mask)])
                        c = S & 0xFF
                        # a zero frequency field is f = tot, wrapped
                        F = (S >> (shift + 8)) or tot
                        R = F * (R >> shift) + ((S >> 8) & mask)
                        if R < RANS_L and ptr < len(wrow):
                            R = ((R << 16) | int(wrow[ptr])) & 0xFFFFFFFF
                            ptr += 1
                        tail[k] = c
                        last = c
                    res = np.concatenate([res, tail])
                out[i] = res[:sz].tobytes()
        return out

    return _finish if lazy else _finish()


decode_o0_batch.calls = 0
decode_o1_batch.calls = 0
