"""ctypes bindings to the native C++ engine (native/libfqz5.so).

The native library provides the sequential, bit-exact hot paths of the
FQZ5 codec family (rANS Nx16, range-coder codecs, LZP, tokenizer).
It is built with ``make -C native`` and loaded lazily; the build is
attempted automatically on first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from array import array

from fqzcomp5_tpu_torch.utils.lazy_np import np

# os.path (not pathlib: pathlib drags urllib.parse + ipaddress,
# ~35ms of CLI cold-start).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# FQZ5_NATIVE_LIB: alternate .so (e.g. an ASan/UBSan build) — the
# sanitizer workflow the reference gets from its Makefile's
# CFLAGS override (fqzcomp5 Makefile).
_LIB_PATH = os.environ.get(
    "FQZ5_NATIVE_LIB", os.path.join(_ROOT, "native", "libfqz5.so"))
_lock = threading.Lock()
_lib = None


def _build() -> None:
    subprocess.run(
        ["make", "-C", os.path.join(_ROOT, "native"), "-j4"],
        check=True,
        capture_output=True,
    )


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build()
        L = ctypes.CDLL(_LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.fqz5_rans_compress.restype = ctypes.c_int64
        L.fqz5_rans_compress.argtypes = [
            u8p, ctypes.c_uint32, ctypes.c_int, u8p, ctypes.c_uint32]
        L.fqz5_rans_uncompress.restype = ctypes.c_int64
        L.fqz5_rans_uncompress.argtypes = [
            u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int]
        _register_optional(L)
        _lib = L
        return L


def _register_optional(L: ctypes.CDLL) -> None:
    """Signatures for codecs added after the first milestone."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, restype, argtypes in [
        ("fqz5_seq_encode", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u32p, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, u8p, ctypes.c_uint32]),
        ("fqz5_seq_decode", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u32p, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, u8p, ctypes.c_uint32]),
        ("fqz5_fqz_compress", ctypes.c_int64,
         [u8p, ctypes.c_uint64, u32p, u32p, u8p, ctypes.c_int,
          ctypes.c_int, u8p, ctypes.c_uint64]),
        ("fqz5_fqz_decompress", ctypes.c_int64,
         [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, u8p]),
        ("fqz5_fqz_prepare", ctypes.c_int64,
         [u8p, ctypes.c_uint64, u32p, u32p, ctypes.c_int, ctypes.c_int,
          u8p, u8p, ctypes.c_uint64, u32p, u32p, ctypes.c_uint64,
          u32p]),
        ("fqz5_lzp", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u8p, ctypes.c_uint32]),
        ("fqz5_unlzp", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u8p, ctypes.c_uint32]),
        ("fqz5_arith_compress", ctypes.c_int64,
         [u8p, ctypes.c_uint32, ctypes.c_int, u8p, ctypes.c_uint32]),
        ("fqz5_arith_uncompress", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u8p, ctypes.c_uint32]),
        ("fqz5_tok3_encode", ctypes.c_int64,
         [u8p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int, u8p,
          ctypes.c_uint32]),
        ("fqz5_tok3_decode", ctypes.c_int64,
         [u8p, ctypes.c_uint32, u8p, ctypes.c_uint32]),
        ("fqz5_gather_ranges", ctypes.c_int64,
         [u8p, i64p, i64p, ctypes.c_int64, u8p]),
        ("fqz5_scatter_ranges", ctypes.c_int64,
         [u8p, i64p, u8p, i64p, ctypes.c_int64]),
        ("fqz5_derive_flags", ctypes.c_int64,
         [u8p, ctypes.c_int64, ctypes.c_int64, u32p]),
        ("fqz5_parse_fastq_chunk", ctypes.c_int64,
         [u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
          i64p, i64p, i64p, i64p]),
        ("fqz5_build_soa", ctypes.c_int64,
         [u8p, ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i64p,
          u8p, u8p, u8p, u32p, u32p]),
        ("fqz5_split_names", ctypes.c_int64,
         [u8p, ctypes.c_int64, u8p, i64p, u8p, u8p, i64p]),
        ("fqz5_join_names", ctypes.c_int64,
         [u8p, ctypes.c_int64, u8p, ctypes.c_int64, u8p,
          ctypes.c_int64, u8p, u32p]),
        ("fqz5_format_fastq", ctypes.c_int64,
         [u8p, ctypes.c_int64, u8p, u8p, u32p, ctypes.c_int64,
          ctypes.c_int, u8p]),
        ("fqz5_varint_get_u32_array", ctypes.c_int64,
         [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u32p]),
        ("fqz5_varint_put_u32_array", ctypes.c_int64,
         [u32p, ctypes.c_int64, u8p]),
        ("fqz5_pack_cut", ctypes.c_int64,
         [i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
          ctypes.c_int64, ctypes.c_int64, i64p]),
        ("fqz5_sum_i64", ctypes.c_int64, [i64p, ctypes.c_int64]),
    ]:
        try:
            fn = getattr(L, name)
        except AttributeError:
            continue
        fn.restype = restype
        fn.argtypes = argtypes


_scratch = threading.local()
_SCRATCH_MAX = 96 << 20  # reuse buffers up to 96MB; larger are one-shot

# Uninitialised bytes constructor (callers overwrite every byte).
_pybytes_uninit = ctypes.pythonapi.PyBytes_FromStringAndSize
_pybytes_uninit.restype = ctypes.py_object
_pybytes_uninit.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]


def _fresh(nbytes):
    """Writable fresh bytes, uninitialised (the C kernels fill every
    byte).  Safe because the object is brand new, unhashed and solely
    owned — EXCEPT len<=1 bytes, which CPython interns (mutating those
    would corrupt shared singletons), hence the bytearray fallback."""
    return (_pybytes_uninit(None, nbytes) if nbytes > 1
            else bytearray(nbytes))


def out_scratch(cap: int) -> tuple:
    """Thread-local reusable output buffer (mirrors the reference's TLS
    arena, utils.c:119-205): avoids a fresh multi-MB allocation per
    codec call.  Returns (buffer, u8 pointer) — an uninitialised
    PyBytes written through its pointer (the _fresh technique:
    bytearray(n) memsets multi-MB on every growth, and numpy would
    defeat utils/lazy_np.py).  The buffer is internal-only: callers
    copy out with take() and never expose it."""
    cap = max(cap, 1)
    if cap > _SCRATCH_MAX:
        arr = _fresh(cap)
    else:
        arr = getattr(_scratch, "buf", None)
        if arr is None or len(arr) < cap:
            arr = _fresh(max(cap + (cap >> 2), 1 << 20))
            _scratch.buf = arr
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if isinstance(arr, bytes):
        ptr = ctypes.cast(ctypes.c_char_p(arr), u8)
    else:
        ptr = ctypes.cast((ctypes.c_uint8 * len(arr)).from_buffer(arr),
                          u8)
    return arr, ptr


def take(buf, n: int) -> bytes:
    """Copy the first n bytes of a scratch buffer out as bytes."""
    return bytes(memoryview(buf)[:n])


def fresh_out(n: int) -> tuple:
    """(writable fresh bytes-like of EXACTLY n bytes, u8 pointer).

    Decoders whose output size is known up front write straight into
    the final bytes object (reference analog: rans_uncompress_to_4x16
    decodes into the caller buffer) — no scratch + take() copy, which
    cost a full memcpy pass per multi-MB section."""
    out = _fresh(n)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if isinstance(out, bytes):
        op = ctypes.cast(ctypes.c_char_p(out), u8)
    else:
        op = (ctypes.cast((ctypes.c_uint8 * len(out)).from_buffer(out), u8)
              if len(out) else ctypes.cast(1, u8))
    return out, op


def seal_out(out, rc: int) -> bytes:
    """Finalise a fresh_out buffer: exact-size hit returns it as-is."""
    if rc == len(out) and isinstance(out, bytes):
        return out
    return bytes(memoryview(out)[:rc])


def _u8(buf) -> tuple:
    """(keep-alive, u8 pointer) for any bytes-like or ndarray input.
    Pure ctypes for bytes/bytearray/memoryview (numpy-free); c_char_p
    holds a reference to the bytes object so the pointer stays valid
    while the keep-alive is."""
    n = len(buf)
    if n == 0:
        # ctypes needs a valid pointer even for empty buffers
        return buf, ctypes.cast(1, ctypes.POINTER(ctypes.c_uint8))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if isinstance(buf, bytes):
        keep = ctypes.c_char_p(buf)
        return keep, ctypes.cast(keep, u8p)
    if isinstance(buf, (bytearray, memoryview)):
        if isinstance(buf, memoryview) and (buf.readonly
                                            or not buf.contiguous):
            return _u8(bytes(buf))
        keep = (ctypes.c_uint8 * n).from_buffer(buf)
        return keep, ctypes.cast(keep, u8p)
    arr = buf if isinstance(buf, np.ndarray) \
        else np.frombuffer(buf, dtype=np.uint8)
    return arr, arr.ctypes.data_as(u8p)


def u32_buf(x) -> tuple:
    """(keep-alive, u32 pointer, count) for a contiguous u32 buffer:
    stdlib array('I'), ndarray, or any sequence (copied)."""
    u32p = ctypes.POINTER(ctypes.c_uint32)
    if isinstance(x, array) and x.typecode == "I":
        n = len(x)
        if n == 0:
            return x, ctypes.cast(1, u32p), 0
        keep = (ctypes.c_uint32 * n).from_buffer(x)
        return keep, ctypes.cast(keep, u32p), n
    if type(x).__name__ == "ndarray":
        arr = np.ascontiguousarray(x, np.uint32)
        if arr.size == 0:
            return arr, ctypes.cast(1, u32p), 0
        return arr, arr.ctypes.data_as(u32p), int(arr.size)
    a = array("I", x)
    return u32_buf(a)


def rans_compress(data: bytes, order: int) -> bytes:
    L = lib()
    n = len(data)
    # generous bound mirroring rans_compress_bound_4x16
    stripe_n = (order >> 8) & 0xFF or 4
    cap = int(1.05 * n) + 257 * 257 * 3 + 1024 + 5 * stripe_n + 128
    out, outp = out_scratch(cap)
    src, src_p = _u8(data)
    rc = L.fqz5_rans_compress(src_p, n, order, outp, cap)
    if rc < 0:
        raise ValueError(f"rans_compress failed (order={order:#x})")
    return take(out, rc)


def rans_uncompress(data: bytes, out_hint: int | None = None) -> bytes:
    from fqzcomp5_tpu_torch.utils import varint

    L = lib()
    n = len(data)
    if n == 0:
        raise ValueError("empty rans stream")
    if out_hint is None:
        if data[0] & 0x10:  # NOSZ: size must come from caller
            raise ValueError("NOSZ stream needs out_hint")
        osz, _ = varint.get_u32(data, 1)
        know = 0
    else:
        osz = out_hint
        know = 1
    out, outp = fresh_out(osz)
    src, src_p = _u8(data)
    rc = L.fqz5_rans_uncompress(src_p, n, outp, osz, osz, know)
    if rc < 0:
        raise ValueError("rans_uncompress failed")
    return seal_out(out, rc)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8_at(buf, off: int):
    """(keep-alive, u8 pointer at byte offset off) into a bytes-like."""
    keep, p = _u8(buf)
    if off:
        p = ctypes.cast(ctypes.cast(p, ctypes.c_void_p).value + off,
                        ctypes.POINTER(ctypes.c_uint8))
    return keep, p


def i64_buf(x) -> tuple:
    """(keep-alive, i64 pointer) for array('q'), ctypes i64 array, or
    ndarray (numpy-free for the stdlib kinds)."""
    i64 = ctypes.POINTER(ctypes.c_int64)
    if isinstance(x, array) and x.typecode == "q":
        if len(x) == 0:
            return x, ctypes.cast(1, i64)
        keep = (ctypes.c_int64 * len(x)).from_buffer(x)
        return keep, ctypes.cast(keep, i64)
    if isinstance(x, ctypes.Array):
        return x, ctypes.cast(x, i64)
    arr = np.ascontiguousarray(x, np.int64)
    return arr, _i64p(arr)


def pack_cut(core_len, seq_s, seq_e, cur: int, budget: int,
             min_take: int) -> tuple:
    """Block-packing cut over parsed record ranges (C scan; see
    fqz5_pack_cut).  Returns (k, taken_acc_total)."""
    L = lib()
    taken = (ctypes.c_int64 * 1)()
    _k1, cp = i64_buf(core_len)
    _k2, sp = i64_buf(seq_s)
    _k3, ep = i64_buf(seq_e)
    k = L.fqz5_pack_cut(cp, sp, ep, len(core_len), cur, budget,
                        min_take, taken)
    return int(k), int(taken[0])


def gather_ranges(data: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray, total: int) -> np.ndarray:
    """Concatenate data[starts[i]:ends[i]] via the native memcpy kernel."""
    L = lib()
    out = np.empty(total, np.uint8)
    if total == 0:
        return out
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    data = np.ascontiguousarray(data)
    _, dp = _u8(data)
    rc = L.fqz5_gather_ranges(
        dp, _i64p(starts), _i64p(ends), len(starts),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert rc == total, (rc, total)
    return out


def scatter_ranges(dst: np.ndarray, dst_starts: np.ndarray,
                   src: np.ndarray, lens: np.ndarray) -> None:
    """Scatter consecutive src slices to dst at dst_starts."""
    L = lib()
    if dst.size == 0 or len(dst_starts) == 0:
        return
    dst_starts = np.ascontiguousarray(dst_starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    src = np.ascontiguousarray(src)
    _, sp = _u8(src)
    L.fqz5_scatter_ranges(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(dst_starts), sp, _i64p(lens), len(lens))


def sum_i64(a) -> int:
    """C-speed sum of an int64 buffer (array('q') or ndarray)."""
    if len(a) == 0:
        return 0
    L = lib()
    _k, p = i64_buf(a)
    return int(L.fqz5_sum_i64(p, len(a)))


def _sum_pairs(a, b) -> int:
    """sum(b[i] - a[i]) for two equal-length int sequences."""
    return sum_i64(b) - sum_i64(a)


def build_soa(data, name_s, name_e, core_len, seq_s, seq_e, qual_s,
              off: int = 0):
    """One-pass SoA materialisation (name/seq/qual buffers, lens,
    FREAD2 flags) from parsed record ranges.  `data` is any bytes-like
    (offsets are relative to `off`) or an ndarray.  Returns
    (name_buf bytes, seq_buf bytes, qual_buf bytes, lens array('I'),
    flags array('I'))."""
    L = lib()
    n = len(name_s)
    nb_total = _sum_pairs(name_s, name_e) + n
    sq_total = _sum_pairs(seq_s, seq_e)
    # C++ fills fresh PyBytes buffers in place: no scratch + copy.
    name_buf, np_ptr = fresh_out(nb_total)
    seq_buf, sp_ptr = fresh_out(sq_total)
    qual_buf, qp_ptr = fresh_out(sq_total)
    lens = array("I", bytes(4 * max(n, 1)))
    flags = array("I", bytes(4 * max(n, 1)))
    if type(data).__name__ == "ndarray":
        data = np.ascontiguousarray(data)
    _dk, dp = _u8_at(data, off)
    _k1, p1 = i64_buf(name_s)
    _k2, p2 = i64_buf(name_e)
    _k3, p3 = i64_buf(core_len)
    _k4, p4 = i64_buf(seq_s)
    _k5, p5 = i64_buf(seq_e)
    _k6, p6 = i64_buf(qual_s)
    _lk, lp, _ = u32_buf(lens)
    _fk, fp, _ = u32_buf(flags)
    rc = L.fqz5_build_soa(dp, n, p1, p2, p3, p4, p5, p6,
                          np_ptr, sp_ptr, qp_ptr, lp, fp)
    assert rc == nb_total, (rc, nb_total)
    return (seal_out(name_buf, nb_total), seal_out(seq_buf, sq_total),
            seal_out(qual_buf, sq_total), lens[:n], flags[:n])


def format_fastq(name_buf: bytes, seq_buf: bytes, qual_buf: bytes,
                 lens: np.ndarray, plus_name: bool) -> bytes:
    """Single-pass FASTQ text assembly (C kernel; decode hot path)."""
    L = lib()
    n = len(lens)
    name_total = len(name_buf) - n  # NUL per record
    out_total = (name_total * (2 if plus_name else 1)
                 + 2 * len(seq_buf) + 6 * n)
    out = _fresh(out_total)
    _lk, lp, _ = u32_buf(lens)
    _, np_ = _u8(name_buf)
    _, sp = _u8(seq_buf)
    _, qp = _u8(qual_buf)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if isinstance(out, bytes):
        op = ctypes.cast(ctypes.c_char_p(out), u8)
    else:
        op = ctypes.cast((ctypes.c_uint8 * len(out)).from_buffer(out), u8)
    rc = L.fqz5_format_fastq(
        np_, len(name_buf), sp, qp, lp, n,
        1 if plus_name else 0, op)
    if rc != out_total:
        raise ValueError("malformed name buffer in format_fastq")
    return bytes(out) if isinstance(out, bytearray) else out


def parse_fastq_chunk(buf, off: int = 0, size: int | None = None):
    """Single-pass 4-line FASTQ chunk scan over buf[off:off+size].
    Returns (name_s, name_e, core_len, seq_s, seq_e, qual_s, tail) as
    stdlib array('q') — offsets relative to `off` — or None when the
    chunk needs the generic-parser fallback.  numpy-free: this is the
    encode CLI path (cold-start: numpy is ~300ms)."""
    L = lib()
    if size is None:
        size = len(buf) - off
    max_rec = size // 6 + 2  # minimal record "@\n\n+\n\n" is 6 bytes
    # Reusable scratch via ANONYMOUS MMAP: the worst-case bound is
    # ~size/6 entries per array, but a ctypes array allocation ZEROES
    # all of it eagerly (6 x ~70MB = ~0.25s on the first 52MB chunk —
    # the dominant cold-CLI parse cost, round 5).  mmap pages are
    # zero-filled lazily on first touch, and the parser only writes
    # the ~nrec-entry prefix, so over-reserving is free.
    import mmap as _mmap

    sc = getattr(_scratch, "parse_mm", None)
    if sc is None or sc[1] < max_rec:
        # +1/8 headroom: chunk sizes wobble by the carried tail
        cap = max_rec + (max_rec >> 3)
        mm = _mmap.mmap(-1, 6 * cap * 8)
        sc = (mm, cap,
              ctypes.addressof(ctypes.c_char.from_buffer(mm)))
        _scratch.parse_mm = sc
    mm, cap, base = sc
    tail = (ctypes.c_int64 * 1)()
    i64 = ctypes.POINTER(ctypes.c_int64)
    ptrs = [ctypes.cast(base + k * cap * 8, i64) for k in range(6)]
    _dk, dp = _u8_at(buf, off)
    rc = L.fqz5_parse_fastq_chunk(dp, size, max_rec, *ptrs,
                                  ctypes.cast(tail, i64))
    if rc < 0:
        return None
    n = int(rc)
    mv = memoryview(mm)
    out = tuple(array("q", bytes(mv[k * cap * 8:k * cap * 8 + n * 8]))
                for k in range(6))
    return out + (int(tail[0]),)


def derive_flags(name_buf: bytes, nrec: int):
    """Decode-side FREAD2 flag rebuild (fqzcomp5.c:2344-2374).
    Returns a stdlib array('I') (numpy-free decode path)."""
    L = lib()
    flags = array("I", bytes(4 * nrec))
    if nrec == 0:
        return flags
    _fk, fp, _ = u32_buf(flags)
    _, np_ = _u8(name_buf)
    rc = L.fqz5_derive_flags(np_, len(name_buf), nrec, fp)
    if rc != nrec:
        raise ValueError("name buffer truncated while deriving flags")
    return flags


def split_names(name_buf: bytes):
    """Strategy-2 name split (fqzcomp5.c:1408-1586 semantics plus the
    explicit-empty-comment fix; see names.py).  Returns
    (ids bytes, flags bytes, comments bytes)."""
    L = lib()
    n = len(name_buf)
    nrec_max = name_buf.count(0) + 1
    ids, idp = fresh_out(n + nrec_max + 1)
    flags, flp = fresh_out(nrec_max + 1)
    comments, cop = fresh_out(n + nrec_max + 1)
    ids_len = (ctypes.c_int64 * 1)()
    com_len = (ctypes.c_int64 * 1)()
    i64 = ctypes.POINTER(ctypes.c_int64)
    _, inp = _u8(name_buf)
    nrec = L.fqz5_split_names(
        inp, n, idp, ctypes.cast(ids_len, i64), flp, cop,
        ctypes.cast(com_len, i64))
    if nrec < 0:
        raise ValueError("split_names failed")
    return (take(ids, int(ids_len[0])), take(flags, int(nrec)),
            take(comments, int(com_len[0])))


def join_names(ids: bytes, flags: bytes, comments: bytes):
    """Inverse of split_names under reference decode semantics
    (fqzcomp5.c:1722-1760).  Returns (name_buf, fread2 array('I'))."""
    L = lib()
    nrec_max = ids.count(0) + 1
    cap = len(ids) + len(comments) + 4 * nrec_max + 16
    out = bytearray(cap)
    fread2 = array("I", bytes(4 * nrec_max))
    _ok, op = _u8(out)
    _fk, fp, _ = u32_buf(fread2)
    _, idp = _u8(ids)
    _, flp = _u8(flags)
    _, cop = _u8(comments)
    n = L.fqz5_join_names(
        idp, len(ids), flp, len(flags), cop, len(comments), op, fp)
    if n < 0:
        raise ValueError("join_names failed")
    nrec = ids.count(0)
    return take(out, n), fread2[:nrec]
