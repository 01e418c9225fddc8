"""Boundary tables of the rANS decode walks, and the walks' plain versions.

The counterpart of the table half of ``fqzcomp5_tpu/ops/rans_pallas_dec.py``:
the TPU decode kernels v1-v4 find each lane's symbol by a
compare-reduction over per-stream boundary tables instead of an s3 LUT
gather.  Order-0 entries are ``(f[j+1] << 14) | C[j+1]`` (the counter
form, any S) or ``((j+1) << 26) | (f[j+1] << 13) | C[j+1]`` (packed,
S <= 64, the symbol rides the entry); order-1 tables are dense: the
alphabet A used anywhere in a batch, its contexts A1 (A, plus byte 0 when
it is absent) and rows of A+1 entries, entry 0 the symbol-0 base.

The numpy builders are copies of the JAX package's
(``build_dec_tables``, ``build_dec_tables_p``, ``build_o1_dense_tables``,
``expand4``), with the same results array for array; the last builds all
streams and contexts at once.  ``freqs_from_s3`` recovers the frequency
tables from the native dec prep's s3 LUTs as the JAX engine does.

``bnd_o0_slot_table`` and ``decode_bnd_o0_compact`` mirror, in numpy,
the per-slot table that csrc/rans_decode_bnd.cu's order-0 kernel builds
on the card from a stream's boundary entries, and its walk over it;
``dense_compact_tables`` and ``decode_dense_compact`` the compact tables
of its dense order-1 kernel, and its walk over them.

The plain versions ``decode_bnd_o0_ref`` and ``decode_dense_o1_ref`` walk
compact per-stream layouts (one row of 32 lane states per stream) and
follow the Pallas kernels step for step: the selected entry is the last
whose boundary is at most m = R & (tot-1), steps at or past t_real move
nothing and write symbol 0, and the word feed reads consecutive words in
lane order (rans_torch._word_feed).  u32 values ride in int64 masked to
32 bits, as in ``rans_torch``.  They are the route of the CUDA wrappers
(``rans_cuda_bnd``) for CPU tensors and the reference the kernels are
held against.
"""

from __future__ import annotations

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops.rans_torch import (M32, N, O1_TABLE_BYTES,
                                               RANS_L, TF_SHIFT, _ring_feed,
                                               _word_feed, as_i32, u32)

S_SLOTS = 4          # streams per 128-lane row in the JAX layouts
LANES = 128
DENSE_MAX_A = 64     # the JAX route's dense order-1 limit (engine_tpu.py:1007)


# ---------------------------------------------------------------------
# numpy table builders (copies of the JAX package's)

def build_dec_tables(freqs: np.ndarray, shift: int, S: int) -> np.ndarray:
    """(B, S) int32 boundary/freq tables: entry j packs
    (freq[j+1] << 14) | C[j+1]; entry S-1 has C[S]=1<<shift so its
    compare never fires.  freqs: (B, 256) summing to 1<<shift; all
    symbols above S-1 must be absent."""
    freqs = np.atleast_2d(freqs).astype(np.int64)
    B = freqs.shape[0]
    if S < 256:
        assert (freqs[:, S:] == 0).all(), "alphabet exceeds bucket"
    C = np.zeros((B, 257), np.int64)
    C[:, 1:] = np.cumsum(freqs, axis=1)
    f_next = np.zeros((B, 256), np.int64)
    f_next[:, :255] = freqs[:, 1:]
    return ((f_next[:, :S] << 14) | C[:, 1:S + 1]).astype(np.int32)


def build_dec_tables_p(freqs: np.ndarray, shift: int,
                       S: int) -> np.ndarray:
    """Packed tables: entry j = ((j+1) << 26) | (freq[j+1] << 13) |
    C[j+1].  Valid for S <= 64 and shift <= 12 (13-bit fields).  The
    selected entry (last j with C[j+1] <= m) decodes symbol j+1 <= S-1,
    so 6 bits suffice; entries whose boundary equals 1<<shift can never
    be selected (m < 1<<shift), so j = S-1's wrapped tag is harmless."""
    assert S <= 64 and shift <= 12
    freqs = np.atleast_2d(freqs).astype(np.int64)
    assert (freqs[:, S:] == 0).all(), "alphabet exceeds bucket"
    B = freqs.shape[0]
    C = np.zeros((B, 257), np.int64)
    C[:, 1:] = np.cumsum(freqs, axis=1)
    f_next = np.zeros((B, 256), np.int64)
    f_next[:, :255] = freqs[:, 1:]
    j = np.arange(S, dtype=np.int64)
    out = ((((j[None, :] + 1) & 63) << 26) | (f_next[:, :S] << 13)
           | C[:, 1:S + 1])
    return (out & M32).astype(np.uint32).view(np.int32)


def build_o1_dense_tables(freqs: np.ndarray, shift: int):
    """Dense-alphabet order-1 boundary tables from (B, 256, 256) context
    freq tables.  Returns (tables (B, A1*(A+1)) int32, alphabet bytes
    (A,), A, A1, last0): row c*(A+1) is context c's symbol-0 entry
    (f0 << 13, or << 14 in the counter form), rows c*(A+1)+1+j its
    boundary entries j, packed as build_dec_tables_p's when A <= 64 and
    as build_dec_tables' (counter form) above."""
    B = freqs.shape[0]
    alphabet = np.flatnonzero(freqs.any(axis=(0, 1)))
    A = len(alphabet)
    if 0 in alphabet:
        A1 = A
        last0 = int(np.searchsorted(alphabet, 0))
        ctx_bytes = alphabet
    else:
        A1 = A + 1
        last0 = A
        ctx_bytes = np.concatenate([alphabet, [0]])
    out = np.zeros((B, A1, A + 1), np.int64)
    sub = freqs[:, ctx_bytes][:, :, alphabet].astype(np.int64)  # (B,A1,A)
    Csub = np.cumsum(sub, axis=2)
    fn = np.zeros_like(sub)
    fn[:, :, :A - 1] = sub[:, :, 1:]
    if A <= 64:
        j = np.arange(A, dtype=np.int64)
        out[:, :, 0] = sub[:, :, 0] << 13
        out[:, :, 1:] = (((j + 1) & 63) << 26) | (fn << 13) | Csub
    else:
        out[:, :, 0] = sub[:, :, 0] << 14
        out[:, :, 1:] = (fn << 14) | Csub
    tabs = (out & M32).astype(np.uint32).view(np.int32)
    return tabs.reshape(B, A1 * (A + 1)), alphabet, A, A1, last0


def expand4(per_stream: np.ndarray) -> np.ndarray:
    """(B, ...) per-stream values -> per-lane (B//4, ..., 128) with
    stream b in lanes (b%4)*32:(b%4+1)*32 of row b//4."""
    B = per_stream.shape[0]
    assert B % S_SLOTS == 0
    rest = per_stream.shape[1:]
    x = per_stream.reshape((B // S_SLOTS, S_SLOTS) + rest + (1,))
    x = np.broadcast_to(x, (B // S_SLOTS, S_SLOTS) + rest + (N,))
    # -> (B4, ..., 4, 32) -> (B4, ..., 128)
    x = np.moveaxis(x, 1, -2)
    return np.ascontiguousarray(
        x.reshape((B // S_SLOTS,) + rest + (LANES,)))


# ---------------------------------------------------------------------
# tables from the native dec prep's s3 LUTs

def freqs_from_s3(s3s: np.ndarray, shift: int) -> np.ndarray:
    """(B, R << shift) uint32 s3 LUTs of R context rows (1 at order-0,
    256 at order-1) -> (B, R, 256) uint32 frequency tables.

    A slot packs f << (shift+8) | bias << 8 | sym, and each symbol's
    slots begin at bias 0, so the frequencies are read at those start
    slots.  A symbol that takes a row's whole total (a single-symbol
    stream, a single-symbol order-1 context at shift 12) stores
    f << (shift+8) = 2^32, which wraps to 0: a zero field there is
    f = tot.  These are the JAX engine's two repairs
    (engine_tpu.py:574-585 and :995-1003); an all-zero row, a context
    that never occurs, gets symbol 0 at f = tot as there."""
    s3s = np.asarray(s3s, np.uint32)
    B, n = s3s.shape
    tot = 1 << shift
    out = np.zeros((B, n >> shift, 256), np.uint32)
    for b in range(B):
        s = s3s[b]
        k = np.flatnonzero((s & ((tot - 1) << 8)) == 0)
        f = s[k] >> (shift + 8)
        f[f == 0] = tot
        out[b].reshape(-1)[(k >> shift) * 256 + (s[k] & 0xFF)] = f
    return out


def o0_tables(s3s: np.ndarray, shift: int = TF_SHIFT):
    """Order-0 boundary tables of a batch, as the JAX route builds them
    (engine_tpu.py:602-613): (tab (B, S) int32, f0 (B,) int32, S,
    packed).  S is the batch's alphabet bucket: 256 when a symbol of 64
    or more is used, else a multiple of 8 from 16 up; packed when
    S <= 64."""
    freqs = freqs_from_s3(s3s, shift)[:, 0]
    max_sym = int(np.max(np.nonzero(freqs.any(0))[0], initial=0))
    S = 256 if max_sym >= 64 else max(16, (max_sym + 8) & ~7)
    packed = S <= 64
    build = build_dec_tables_p if packed else build_dec_tables
    return (build(freqs, shift, S), freqs[:, 0].astype(np.int32), S,
            packed)


# ---------------------------------------------------------------------
# plain walks

def select_entry(E, base, m, valid, packed: bool):
    """The compare-reduction of one step.  E (B, 32, n) int64 entries,
    base (B, 32) the entry when no boundary is at most m, valid (B, 32)
    False where a lane has no table row (its P, symbol, F and C are 0).
    Returns (sym, F, C) as int64."""
    cm = 0x1FFF if packed else 0x3FFF
    ge = (E & cm) <= m.unsqueeze(-1)
    pos = torch.arange(E.shape[-1], device=E.device)
    last = torch.where(ge, pos, -1).amax(-1)
    P = torch.gather(E, 2, last.clamp(min=0).unsqueeze(-1)).squeeze(-1)
    P = torch.where(last >= 0, P, base)
    P = torch.where(valid, P, 0)
    if packed:
        return P >> 26, (P >> 13) & 0x1FFF, P & 0x1FFF
    sym = torch.where(valid, ge.sum(-1), 0)
    # int32 arithmetic shift of the entry, as the JAX kernels take it
    F = ((P - ((P >> 31) << 32)) >> 14) & M32
    return sym, F, torch.where(sym > 0, P & 0x3FFF, 0)


def _walk(words, R0, t_real, T, shift, step):
    """The loop both plain walks share: step(t, R, m, active) gives the
    (sym, F, C) of every lane."""
    B = words.shape[0]
    dev = words.device
    mask = (1 << shift) - 1
    w = words.to(torch.int64) & 0xFFFF
    R = u32(R0)
    tr = t_real.to(torch.int64).view(B, 1)
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    syms = torch.zeros((T, B, N), dtype=torch.uint8, device=dev)
    for t in range(T):
        active = t < tr
        m = R & mask
        sym, F, C = step(m, active)
        Rn = (F * (R >> shift) + (m - C)) & M32
        Rn, ptr = _word_feed(Rn, (Rn < RANS_L) & active, ptr, w)
        R = torch.where(active, Rn, R)
        syms[t] = torch.where(active, sym, 0).to(torch.uint8)
    return (syms.transpose(0, 1).contiguous(), as_i32(R),
            ptr.to(torch.int32))


def decode_bnd_o0_ref(words: torch.Tensor, R0: torch.Tensor,
                      tab: torch.Tensor, f0: torch.Tensor,
                      t_real: torch.Tensor, T: int, S: int, *,
                      packed: bool, shift: int = TF_SHIFT):
    """Order-0 boundary-table decode walk (the Pallas decode_walk,
    decode_walk4, decode_walk4v3 and decode_walk4v4 on compact layouts).

    words (B, W) int16 (W >= 1), R0 (B, 32) int32, tab (B, S) int32
    entries of build_dec_tables (packed=False) or build_dec_tables_p
    (packed=True), f0 (B,) int32 symbol-0 frequencies, t_real (B,)
    active step counts.  Returns (syms (B, T, 32) uint8, 0 past t_real;
    Rf (B, 32) int32; ptrf (B,) int32 words consumed)."""
    E = u32(tab).view(tab.shape[0], 1, S).expand(-1, N, -1)
    base = (u32(f0) << (13 if packed else 14)).view(-1, 1).expand(-1, N)
    valid = torch.ones_like(base, dtype=torch.bool)
    return _walk(words, R0, t_real, T, shift,
                 lambda m, active: select_entry(E, base, m, valid, packed))


def decode_dense_o1_ref(words: torch.Tensor, R0: torch.Tensor,
                        tab: torch.Tensor, t_real: torch.Tensor, T: int,
                        shift: int, A: int, A1: int, last0: int):
    """Order-1 dense-table decode walk (the Pallas decode_walk4v3_o1 on
    compact layouts).  tab (B, A1*(A+1)) int32 from
    build_o1_dense_tables, packed when A <= 64; each lane's row is its
    last dense symbol, last0 at the start.  A lane whose last symbol has
    no row (only a corrupt stream gets there) decodes symbol 0 with
    F = C = 0, as the Pallas kernel's context loop does.  Returns (syms
    (B, T, 32) uint8 dense indices, 0 past t_real; Rf (B, 32) int32;
    ptrf (B,) int32 words consumed)."""
    B = words.shape[0]
    packed = A <= DENSE_MAX_A
    tabs = u32(tab)
    cols = torch.arange(A, device=tab.device)
    last = torch.full((B, N), last0, dtype=torch.int64, device=tab.device)

    def step(m, active):
        nonlocal last
        valid = (last >= 0) & (last < A1)
        row = torch.where(valid, last, 0) * (A + 1)
        base = torch.gather(tabs, 1, row)
        E = torch.gather(tabs, 1, (row.unsqueeze(-1) + 1 + cols)
                         .view(B, -1)).view(B, N, A)
        sym, F, C = select_entry(E, base, m, valid, packed)
        last = torch.where(active, sym, last)
        return sym, F, C

    return _walk(words, R0, t_real, T, shift, step)


# ---------------------------------------------------------------------
# numpy mirror of the order-0 boundary decode kernel's slot table and walk

def bnd_o0_slot_table(tab_row, f0: int, S: int, packed: bool, shift: int):
    """The per-slot table csrc/rans_decode_bnd.cu's decode_bnd_o0 prologue
    builds from one stream's S entries (build_dec_tables or
    build_dec_tables_p) and its symbol-0 frequency f0: (sym (tot,) uint8,
    F (tot,) uint32, bias (tot,) int64 m - C), what select_entry gives at
    each slot m.  The selected entry, the last whose boundary is at most
    m (the base where none is), is filled as runs, entry c from its
    boundary to the least boundary after it; the counter form's symbol is
    the count of boundaries at most m, whatever order they are in."""
    tot = 1 << shift
    E = np.asarray(tab_row).view(np.uint32)[:S].astype(np.int64)
    bnd = np.minimum(E & (0x1FFF if packed else 0x3FFF), tot)
    after = np.minimum.accumulate(np.append(bnd, tot)[::-1])[::-1]
    lo = np.concatenate([[0], bnd])
    P = np.concatenate([[(int(f0) << (13 if packed else 14)) & M32], E])
    sel = np.zeros(tot, np.int64)
    for r in range(S + 1):
        sel[lo[r]:after[r]] = r
    P = P[sel]
    if packed:
        sym, F, C = P >> 26, (P >> 13) & 0x1FFF, P & 0x1FFF
    else:
        sym = np.cumsum(np.bincount(bnd[bnd < tot], minlength=tot))
        F = (((P ^ 0x80000000) - 0x80000000) >> 14) & M32
        C = P & 0x3FFF
    return ((sym & 0xFF).astype(np.uint8), F.astype(np.uint32),
            np.arange(tot) - C)


def decode_bnd_o0_compact(words, R0, tab, f0, t_real, T: int, S: int, *,
                          packed: bool, shift: int = TF_SHIFT):
    """decode_bnd_o0_ref as the kernel steps it over bnd_o0_slot_table, in
    numpy: a slot's two shared words, F and (m - C) << 8 | sym, the second
    sign-extended on read; the rows past t_real 0.  The same arguments
    and results as decode_bnd_o0_ref, as numpy arrays (syms (B, T, 32)
    uint8, Rf (B, 32) uint32, ptrf (B,) int32)."""
    words = np.asarray(words).view(np.uint16).astype(np.int64)
    R0 = np.asarray(R0).view(np.uint32).astype(np.int64)
    B = words.shape[0]
    mask = (1 << shift) - 1
    syms = np.zeros((B, T, N), np.uint8)
    Rf = np.empty((B, N), np.uint32)
    ptrf = np.empty(B, np.int32)
    for b in range(B):
        sym, F, bias = bnd_o0_slot_table(tab[b], f0[b], S, packed, shift)
        hi = ((bias << 8) | sym) & M32
        bias = ((hi ^ 0x80000000) - 0x80000000) >> 8
        F = F.astype(np.int64)
        R = R0[b].copy()
        ptr = 0
        for t in range(max(0, min(int(t_real[b]), T))):
            m = R & mask
            Rn = (F[m] * (R >> shift) + bias[m]) & M32
            R, ptr = _ring_feed(Rn, words[b], ptr)
            syms[b, t] = hi[m] & 0xFF
        Rf[b] = R
        ptrf[b] = ptr
    return syms, Rf, ptrf


# ---------------------------------------------------------------------
# numpy mirror of the dense order-1 decode kernel's compact tables and walk

def dense_table_bytes(A: int, shift: int) -> int:
    """Bytes of one stream's compact dense tables: a u32 word per (row,
    entry) and a u8 slot code per (row, slot), A + 1 rows."""
    return 4 * (A + 1) ** 2 + ((A + 1) << shift)


def dense_route(A: int, shift: int) -> str:
    """Where the kernel keeps a stream's compact tables: "shared" when
    they fit the block's shared memory beside its head, else "global"."""
    return "shared" if dense_table_bytes(A, shift) <= O1_TABLE_BYTES \
        else "global"


def dense_compact_tables(tab_row: np.ndarray, A: int, A1: int, shift: int):
    """The compact tables csrc/rans_decode_bnd.cu's decode_dense_o1
    prologue builds from one stream's dense rows (A1 * (A+1) int32
    entries of build_o1_dense_tables): (slot (A+1, tot) uint8, the entry
    each slot selects, the last whose boundary is at most the slot,
    filled as runs from each entry's boundary to the least boundary
    after it; words (A+1, A+1) uint32, entry c's F << 14 | C).  Row A,
    when A1 = A, is the context with no row: codes and words 0.  The
    runs cover every slot once whatever the boundaries; where they rise,
    as build_o1_dense_tables makes them, a slot's entry is also the count
    of boundaries at most the slot."""
    tot = 1 << shift
    n1 = A + 1
    packed = A <= DENSE_MAX_A
    E = np.zeros((n1, n1), np.int64)
    E[:A1] = np.asarray(tab_row).view(np.uint32).reshape(A1, n1)
    if packed:
        words = ((E >> 13) & 0x1FFF) << 14 | (E & 0x1FFF)
    else:
        words = E.copy()
        words[:, 0] &= ~0x3FFF
    words[A1:] = 0
    bnd = np.minimum(E[:, 1:] & (0x1FFF if packed else 0x3FFF), tot)
    lo = np.concatenate([np.zeros((n1, 1), np.int64), bnd], 1)
    after = np.minimum.accumulate(bnd[:, ::-1], axis=1)[:, ::-1]
    hi = np.concatenate([after, np.full((n1, 1), tot)], 1)
    slot = np.zeros((n1, tot), np.uint8)
    for r in range(A1):
        for c in range(n1):
            slot[r, lo[r, c]:hi[r, c]] = c
    return slot, (words & M32).astype(np.uint32)


def decode_dense_compact(words, R0, tab, t_real, T: int, shift: int,
                         A: int, A1: int, last0: int):
    """decode_dense_o1_ref as the kernel steps it over
    dense_compact_tables, in numpy: a slot's code c is the entry, the
    symbol and (masked to 6 bits in the packed form) the next context.
    The same arguments and results as decode_dense_o1_ref, as numpy
    arrays (syms (B, T, 32) uint8, Rf (B, 32) uint32, ptrf (B,) int32)."""
    words = np.asarray(words).view(np.uint16).astype(np.int64)
    R0 = np.asarray(R0).view(np.uint32).astype(np.int64)
    tab = np.asarray(tab)
    B = words.shape[0]
    mask = (1 << shift) - 1
    cmask = 63 if A <= DENSE_MAX_A else 255
    syms = np.zeros((B, T, N), np.uint8)
    Rf = np.empty((B, N), np.uint32)
    ptrf = np.empty(B, np.int32)
    for b in range(B):
        slot, wt = dense_compact_tables(tab[b], A, A1, shift)
        wt = wt.view(np.int32).astype(np.int64)
        R = R0[b].copy()
        ctx = np.full(N, last0, np.int64)
        ptr = 0
        for t in range(max(0, min(int(t_real[b]), T))):
            m = R & mask
            c = slot[ctx, m].astype(np.int64)
            P = wt[ctx, c]
            ctx = c & cmask
            Rn = ((P >> 14) * (R >> shift) + m - (P & 0x3FFF)) & M32
            R, ptr = _ring_feed(Rn, words[b], ptr)
            syms[b, t] = ctx
        Rf[b] = R
        ptrf[b] = ptr
    return syms, Rf, ptrf
