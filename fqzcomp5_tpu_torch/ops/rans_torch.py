"""Plain PyTorch versions of the three rANS walks, and the table builders.

These are the reference formulations the CUDA kernels are held against
(``rans_cuda.encode_walk``, ``rans_cuda_dec.decode_o0``/``decode_o1``),
and the route those wrappers take for tensors on the CPU.  They run on
any device, one Python step per symbol row, with every stream of the
batch and all 32 lanes vectorised.

torch has no uint32 shifts, adds, compares or divides on the CPU, so
u32 values are carried in int64 and masked to 32 bits.  At the
functions' edges u32 values travel as int32 tensors holding the same
bits, and u16 words as int16 tensors.

The numpy table builders are copies of the JAX package's
(``rans_jax.build_enc_tables``/``build_s3``/``assemble_o0_stream`` and
``rans_pallas.build_packed_tables``), which cannot be imported without
importing jax.
"""

from __future__ import annotations

import numpy as np
import torch

from fqzcomp5_tpu_torch.ops import devtimer

N = 32            # interleaved states
RANS_L = 1 << 15
TF_SHIFT = 12     # order-0
MASK12 = (1 << TF_SHIFT) - 1
M32 = 0xFFFFFFFF
# the order-1 decode kernel's compact tables (csrc/rans_decode.cu): the
# zero entry's flag in a packed word, and the shared-memory bytes its
# slot tables and packed words may take (kSmemBytes - kHeadBytes)
O1_ZERO_FLAG = 1 << 12
O1_TABLE_BYTES = 232448 - 9104


# ---------------------------------------------------------------------
# numpy table builders (copies of the JAX package's)

def build_enc_tables(freqs: np.ndarray, shift: int):
    """Per-symbol (x_max, rcp, rcp_shift, bias, cmpl) arrays.

    freqs: (..., 256) normalised to sum 1<<shift (rows of zeros allowed
    for absent order-1 contexts).  Mirrors RansEncSymbolInit
    (rANS_word.h:195-260)."""
    f64 = np.ascontiguousarray(freqs, np.int64)
    start = np.cumsum(f64, axis=-1) - f64
    x_max = (((RANS_L >> shift) << 16) * f64 - 1).astype(np.uint32)
    cmpl = ((1 << shift) - f64).astype(np.uint32)
    rcp = np.full(f64.shape, 0xFFFFFFFF, np.uint32)
    rcp_shift = np.zeros(f64.shape, np.uint32)
    bias = (start + (1 << shift) - 1).astype(np.uint32)
    flat_f = f64.reshape(-1)
    nz = np.flatnonzero(flat_f >= 2)
    if nz.size:
        fv = flat_f[nz].astype(np.uint64)
        sh = np.ceil(np.log2(fv.astype(np.float64))).astype(np.uint64)
        sh = np.where((np.uint64(1) << sh) < fv, sh + 1, sh)
        r = ((np.uint64(1) << (sh + np.uint64(31))) + fv
             - np.uint64(1)) // fv
        rcp.reshape(-1)[nz] = r.astype(np.uint32)
        rcp_shift.reshape(-1)[nz] = (sh - 1).astype(np.uint32)
        bias.reshape(-1)[nz] = start.reshape(-1)[nz].astype(np.uint32)
    return x_max, rcp, rcp_shift, bias, cmpl


def build_s3(freqs: np.ndarray, shift: int) -> np.ndarray:
    """Flattened decode LUT: slot -> freq<<(shift+8) | bias<<8 | sym.

    freqs: (..., 256), each row normalised to 1<<shift or all zero (a
    zero row gives a zero LUT row); returns (..., 1<<shift) uint32.
    Mirrors rans_F_to_s3 (rANS_static16_int.h:540); vectorised over
    rows, unlike rans_jax.build_s3, with the same result."""
    tot = 1 << shift
    rows = freqs.reshape(-1, 256).astype(np.int64)
    sums = rows.sum(1)
    if not np.isin(sums, (0, tot)).all():
        raise ValueError(f"freq rows must sum to 0 or {tot}")
    out = np.zeros((rows.shape[0], tot), np.uint32)
    used = np.flatnonzero(sums)
    fu = rows[used]
    sym = np.repeat(np.tile(np.arange(256), len(used)), fu.reshape(-1))
    sym = sym.reshape(len(used), tot)
    f = np.take_along_axis(fu, sym, 1)
    bias = (np.arange(tot)[None, :]
            - np.take_along_axis(np.cumsum(fu, 1) - fu, sym, 1))
    out[used] = ((f << (shift + 8)) | (bias << 8) | sym) & 0xFFFFFFFF
    return out.reshape(freqs.shape[:-1] + (tot,))


def assemble_o0_stream(final_states: np.ndarray, words: np.ndarray,
                       mask: np.ndarray) -> bytes:
    """One stream's payload after the freq table, from a walk's (word,
    emit) planes: 32 flush states, then the emitted words in (t asc,
    z asc) order."""
    flush = final_states.astype("<u4").tobytes()
    w = words.reshape(-1)[mask.reshape(-1)].astype("<u2")
    return flush + w.tobytes()


def build_packed_tables(freqs: np.ndarray, shift: int) -> np.ndarray:
    """(B, S+1) int32 packed (f << shift) | start tables.

    freqs: (B, ..., 256), each trailing 256-row one context's table
    normalised to sum 1<<shift (order-0: (B, 256); order-1:
    (B, 256, 256)).  Index S is the no-op sentinel
    (f = 1<<shift, start = 0)."""
    freqs = np.atleast_2d(freqs).astype(np.int64)
    B = freqs.shape[0]
    start = np.cumsum(freqs, axis=-1) - freqs
    packed = ((freqs << shift) | start).reshape(B, -1)
    S = packed.shape[1]
    out = np.zeros((B, S + 1), np.int32)
    out[:, :S] = packed.astype(np.int32)
    out[:, S] = 1 << (2 * shift)
    return out


def tables_from_numpy(a: np.ndarray, kind: str, *, shift: int = TF_SHIFT,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Coder tables as the tensors the kernels and plain versions take.

    kind "freqs": (B, 256) or (B, 256, 256) normalised freq rows ->
    (B, S+1) int32 packed entries at `shift`; "packed": entries already
    packed as by build_packed_tables; "s3": (B, n) uint32 decode LUTs
    from the native dec prep -> int32 tensor with the same bits."""
    if kind == "freqs":
        a = build_packed_tables(a, shift)
    elif kind == "packed":
        a = np.asarray(a, np.int32)
    elif kind == "s3":
        a = np.asarray(a, np.uint32).view(np.int32)
    else:
        raise ValueError(f"unknown table kind {kind!r}")
    return devtimer.put(a, device)


def enc_symbols(tab, shift: int):
    """Encoder symbols of packed (f << shift) | start entries, as the
    CUDA encode walk forms them (csrc/rans_encode.cu enc_symbol, with
    RansEncSymbolInit's formulas): int64 arrays (x_max, rcp, rsh, bias,
    cmpl) of tab's shape."""
    P = np.asarray(tab).astype(np.int64) & M32
    f = P >> shift
    start = P & ((1 << shift) - 1)
    big = f >= 2
    # ceil(log2 f): the bit length of f - 1
    sh = np.frexp(np.maximum(f - 1, 0).astype(np.float64))[1].astype(np.int64)
    x_max = (f << (31 - shift)) - 1
    rcp = np.where(big, ((1 << (sh + 31)) + f - 1) // np.maximum(f, 1), M32)
    rsh = np.where(big, sh - 1, 0)
    bias = np.where(big, start, start + (1 << shift) - 1)
    return x_max, rcp, rsh, bias, (1 << shift) - f


def enc_step(R, sym) -> tuple[np.ndarray, np.ndarray]:
    """One encode step of states R (int64, < 2^31) by encoder symbols
    sym = enc_symbols(...) entries, in the CUDA walk's reciprocal form:
    (next R, emit)."""
    x_max, rcp, rsh, bias, cmpl = sym
    emit = R > x_max
    R = np.where(emit, R >> 16, R)
    q = ((R * rcp) >> 32) >> rsh
    return (R + bias + q * cmpl) & M32, emit


# ---------------------------------------------------------------------
# int64 <-> bit-pattern helpers

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or wider) tensor holding u32 bits -> int64 values."""
    return x.to(torch.int64) & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return (((x & M32) + (1 << 31)) & M32).sub_(1 << 31).to(torch.int32)


def as_i16(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> int16 tensor with the same bits."""
    return ((x + (1 << 15)) & 0xFFFF).sub_(1 << 15).to(torch.int16)


# ---------------------------------------------------------------------
# encode walk

def encode_walk_ref(idx: torch.Tensor, tab: torch.Tensor, shift: int,
                    R0: torch.Tensor | None = None,
                    nsym: torch.Tensor | None = None):
    """Reversed 32-lane encode walk over per-stream packed tables.

    idx: (B, T, 32) table indices -- uint8 symbols with nsym (B,) giving
    each stream's symbol count (slot t*32+z >= nsym takes the sentinel),
    or int32 flat indices holding the sentinel themselves.  tab: (B, S+1)
    int32 packed (f<<shift)|start entries, index S the no-op sentinel.
    R0: optional (B, 32) int32 initial states (u32 bits).

    Returns (Rf (B, 32) int32, words (B, T*32) int16, nwords (B,) int32):
    stream b's compact payload words are words[b, T*32 - nwords[b]:],
    in (t asc, z asc) order."""
    B, T, n = idx.shape
    dev = idx.device
    cap = T * n
    sentinel = tab.shape[1] - 1
    ix = idx.to(torch.int64)
    if nsym is not None:
        pos = torch.arange(cap, device=dev).view(1, T, n)
        ix = torch.where(pos < nsym.to(torch.int64).view(B, 1, 1), ix,
                         sentinel)
    # table values depend only on the plane, so gather them up front
    P = torch.gather(u32(tab), 1, ix.view(B, -1)).view(B, T, n)
    P = P.transpose(0, 1).contiguous()            # (T, B, n)
    f = P >> shift
    cmpl = (1 << shift) - f
    start = P & ((1 << shift) - 1)
    R = (torch.full((B, n), RANS_L, dtype=torch.int64, device=dev)
         if R0 is None else u32(R0))
    Rs = torch.empty((T, B, n), dtype=torch.int64, device=dev)
    hs = 31 - shift
    for t in range(T - 1, -1, -1):
        Rs[t] = R
        R = torch.where((R >> hs) >= f[t], R >> 16, R)
        q = torch.div(R, f[t], rounding_mode="floor")
        R = (R + q * cmpl[t] + start[t]) & M32
    emit = ((Rs >> hs) >= f).transpose(0, 1).reshape(B, cap)
    wv = (Rs & 0xFFFF).transpose(0, 1).reshape(B, cap)
    nw = emit.sum(1)
    rank = emit.cumsum(1) - 1
    dest = (torch.arange(B, device=dev).view(B, 1) * cap
            + (cap - nw).view(B, 1) + rank)
    words = torch.zeros(B * cap, dtype=torch.int16, device=dev)
    words[dest[emit]] = as_i16(wv[emit])
    return as_i32(R), words.view(B, cap), nw.to(torch.int32)


# ---------------------------------------------------------------------
# decode walks

def _advance(S, R, shift):
    """State after decoding slot R & (tot-1), whose s3 entry is S.  A
    zero frequency field means f = tot: that frequency, a symbol taking
    the whole total, wraps to 0 in the u32 table (rans_jax's scans take
    it as 0, which leaves an order-1 lane wrong after such a context)."""
    mask = (1 << shift) - 1
    F = S >> (shift + 8)
    F = torch.where(F == 0, 1 << shift, F)
    return (F * (R >> shift) + ((S >> 8) & mask)) & M32


def _word_feed(Rn, need, ptr, w):
    """Renormalise the lanes in `need` from the shared word row (lane
    order), clipping reads to the row's last word as decode_scan does."""
    offs = need.to(torch.int64).cumsum(1)
    idx = (ptr.view(-1, 1) + offs - 1).clamp(0, w.shape[1] - 1)
    wv = torch.gather(w, 1, idx)
    Rn = torch.where(need, ((Rn << 16) | wv) & M32, Rn)
    return Rn, ptr + offs[:, -1]


def decode_o0_ref(words: torch.Tensor, R0: torch.Tensor, s3: torch.Tensor,
                  t_real: torch.Tensor, T: int, shift: int = TF_SHIFT):
    """Order-0 decode walk (rans_jax.decode_scan semantics, except that
    a zero frequency field is read as f = tot; see _advance).

    words: (B, W) int16 u16 words (W >= 1); R0: (B, 32) int32 states;
    s3: (B, 1<<shift) int32 LUTs; t_real: (B,) active step counts.
    Steps at or past t_real keep the state and read no words.  Returns
    (syms (B, T, 32) uint8, Rf (B, 32) int32)."""
    B = words.shape[0]
    dev = words.device
    mask = (1 << shift) - 1
    w = words.to(torch.int64) & 0xFFFF
    lut = u32(s3)
    R = u32(R0)
    tr = t_real.to(torch.int64).view(B, 1)
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    syms = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
    for t in range(T):
        active = t < tr
        S = torch.gather(lut, 1, R & mask)
        syms[t] = (S & 0xFF).to(torch.uint8)
        Rn = _advance(S, R, shift)
        Rn, ptr = _word_feed(Rn, (Rn < RANS_L) & active, ptr, w)
        R = torch.where(active, Rn, R)
    return syms.transpose(0, 1).contiguous(), as_i32(R)


def decode_o1_ref(words: torch.Tensor, R0: torch.Tensor, s3: torch.Tensor,
                  t_real: torch.Tensor, T: int, shift: int):
    """Order-1 decode walk (rans_jax.decode_scan_o1 semantics, with
    _advance's reading of a zero frequency field): each
    lane carries its last symbol (0 at the start) as the context into
    s3 (B, 256 << shift).  Steps at or past t_real repeat the last
    symbol.  Returns (syms (B, T, 32) uint8, Rf (B, 32) int32,
    ptrf (B,) int32 words consumed)."""
    B = words.shape[0]
    dev = words.device
    tot = 1 << shift
    mask = tot - 1
    w = words.to(torch.int64) & 0xFFFF
    lut = u32(s3)
    R = u32(R0)
    tr = t_real.to(torch.int64).view(B, 1)
    last = torch.zeros((B, N), dtype=torch.int64, device=dev)
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    syms = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
    for t in range(T):
        active = t < tr
        S = torch.gather(lut, 1, last * tot + (R & mask))
        Rn = _advance(S, R, shift)
        Rn, ptr = _word_feed(Rn, (Rn < RANS_L) & active, ptr, w)
        R = torch.where(active, Rn, R)
        last = torch.where(active, S & 0xFF, last)
        syms[t] = last.to(torch.uint8)
    return (syms.transpose(0, 1).contiguous(), as_i32(R),
            ptr.to(torch.int32))


# ---------------------------------------------------------------------
# numpy mirrors of the decode kernels' walks (csrc/rans_decode.cu)

def _ring_feed(Rn, words_b, ptr: int):
    """The kernels' ring feed of one stream's 32 lanes (numpy int64): the
    renormalising lanes take the next words in lane order, reads past the
    row take its last word.  Returns (R, ptr)."""
    need = Rn < RANS_L
    i = ptr + np.cumsum(need) - 1
    v = words_b[np.minimum(i, len(words_b) - 1)]
    return (np.where(need, ((Rn << 16) | v) & M32, Rn),
            ptr + int(need.sum()))


def decode_o0_staged(words, R0, s3, t_real, T: int):
    """The order-0 decode walk as the kernel steps it, in numpy: the s3
    LUT (shift 12), the ring feed, and the rows past t_real (each lane's
    h.last) the symbol of the frozen state.  The same arguments and
    results as decode_o0_ref, as numpy arrays (syms (B, T, 32) uint8,
    Rf (B, 32) uint32)."""
    words = np.asarray(words).view(np.uint16).astype(np.int64)
    R0 = np.asarray(R0).view(np.uint32).astype(np.int64)
    s3 = np.asarray(s3).view(np.uint32).astype(np.int64)
    B = words.shape[0]
    syms = np.empty((B, T, N), np.uint8)
    Rf = np.empty((B, N), np.uint32)
    for b in range(B):
        R = R0[b].copy()
        ptr = 0
        tr = max(0, min(int(t_real[b]), T))
        for t in range(tr):
            S = s3[b, R & MASK12]
            F = S >> (TF_SHIFT + 8)
            F = np.where(F == 0, 1 << TF_SHIFT, F)
            Rn = (F * (R >> TF_SHIFT) + ((S >> 8) & MASK12)) & M32
            R, ptr = _ring_feed(Rn, words[b], ptr)
            syms[b, t] = S & 0xFF
        syms[b, tr:] = s3[b, R & MASK12] & 0xFF
        Rf[b] = R
    return syms, Rf


def o1_compact_tables(s3_row: np.ndarray, shift: int):
    """The compact tables csrc/rans_decode.cu's order-1 prologue builds
    from one stream's s3 LUTs (256 << shift u32): (alpha (A,) bytes, in
    order, byte 0 first; route "shared", "global" or "s3"; slot (A, tot)
    uint8 codes, code A for a zero entry; ptab (A, A+1) uint32 packed
    f << 16 | start, column A the zero entry).  slot and ptab are None on
    the "s3" route (a 256-byte alphabet).  Entries the kernel leaves
    unwritten (codes that no slot of the row gives) are 0 here."""
    tot = 1 << shift
    s3 = np.asarray(s3_row, np.uint32).reshape(256, tot).astype(np.int64)
    present = np.zeros(256, bool)
    present[0] = True
    present[s3[s3 != 0] & 0xFF] = True
    alpha = np.flatnonzero(present)
    A = len(alpha)
    if A > 255:
        return alpha, "s3", None, None
    route = ("shared" if A * tot + 4 * A * (A + 1) <= O1_TABLE_BYTES
             else "global")
    dense = np.zeros(256, np.int64)
    dense[alpha] = np.arange(A)
    rows = s3[alpha]
    nz = rows != 0
    code = np.where(nz, dense[rows & 0xFF], A)
    f = rows >> (shift + 8)
    f = np.where(f == 0, tot, f)
    start = (np.arange(tot)[None, :] - ((rows >> 8) & (tot - 1))) & 0xFFF
    ptab = np.zeros((A, A + 1), np.int64)
    ctx = np.broadcast_to(np.arange(A)[:, None], rows.shape)
    ptab[ctx[nz], code[nz]] = f[nz] << 16 | start[nz]
    ptab[:, A] = tot << 16 | O1_ZERO_FLAG
    return alpha, route, code.astype(np.uint8), ptab.astype(np.uint32)


def decode_o1_compact(words, R0, s3, t_real, T: int, shift: int):
    """The order-1 decode walk as the kernel steps it over
    o1_compact_tables (the "s3" route steps as decode_o1_ref), in numpy:
    the same arguments and results as decode_o1_ref, as numpy arrays
    (syms (B, T, 32) uint8, Rf (B, 32) uint32, ptrf (B,) int32)."""
    words = np.asarray(words).view(np.uint16).astype(np.int64)
    R0 = np.asarray(R0).view(np.uint32).astype(np.int64)
    s3 = np.asarray(s3).view(np.uint32)
    B = words.shape[0]
    tot = 1 << shift
    mask = tot - 1
    syms = np.empty((B, T, N), np.uint8)
    Rf = np.empty((B, N), np.uint32)
    ptrf = np.empty(B, np.int32)
    for b in range(B):
        alpha, route, slot, ptab = o1_compact_tables(s3[b], shift)
        lut = s3[b].astype(np.int64)
        A = len(alpha)
        R = R0[b].copy()
        ctx = np.zeros(N, np.int64)
        ptr = 0
        tr = max(0, min(int(t_real[b]), T))
        for t in range(tr):
            m = R & mask
            if route == "s3":
                S = lut[(ctx << shift) + m]
                F = S >> (shift + 8)
                F = np.where(F == 0, tot, F)
                Rn = (F * (R >> shift) + ((S >> 8) & mask)) & M32
                ctx = S & 0xFF
            else:
                code = slot[ctx, m].astype(np.int64)
                P = ptab[ctx, code].astype(np.int64)
                ctx = np.where(code == A, 0, code)
                start = np.where(P & O1_ZERO_FLAG, m, P & 0xFFF)
                Rn = ((P >> 16) * (R >> shift) + m - start) & M32
            R, ptr = _ring_feed(Rn, words[b], ptr)
            syms[b, t] = ctx if route == "s3" else alpha[ctx]
        last = ctx if route == "s3" else alpha[ctx]
        syms[b, tr:] = last
        Rf[b] = R
        ptrf[b] = ptr
    return syms, Rf, ptrf
