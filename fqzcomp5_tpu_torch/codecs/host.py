"""High-level Python API over the native engine for every FQZ5 codec.

Each function is bytes-in/bytes-out and mirrors a reference entry point:
rans (rans_compress_to_4x16), seq (encode_seq), fqz (fqz_compress),
lzp (lzp16e), arith (arith_compress_to), tok3 (tok3_encode_names).
"""

from __future__ import annotations

import ctypes

from fqzcomp5_tpu_torch.utils.lazy_np import np

from fqzcomp5_tpu_torch.codecs import native
from fqzcomp5_tpu_torch.codecs.native import rans_compress, rans_uncompress  # noqa: F401

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _ptr(buf):
    # numpy-free for bytes-like inputs: the decode path must not pull
    # the ~300ms numpy import (see utils/lazy_np.py).  c_char_p keeps a
    # reference to the bytes object, so the pointer stays valid while
    # the returned keep-alive is.
    n = len(buf)
    if n == 0:
        return ctypes.cast(1, _u8p), buf
    if isinstance(buf, bytes):
        keep = ctypes.c_char_p(buf)
        return ctypes.cast(keep, _u8p), keep
    if isinstance(buf, (bytearray, memoryview)):
        if isinstance(buf, memoryview) and (buf.readonly
                                            or not buf.contiguous):
            return _ptr(bytes(buf))
        keep = (ctypes.c_uint8 * n).from_buffer(buf)
        return ctypes.cast(keep, _u8p), keep
    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    return arr.ctypes.data_as(_u8p), arr


def _out(cap: int):
    return native.out_scratch(cap)


def seq_encode(seq_buf: bytes, lens, both_strands: int, ctx_size: int) -> bytes:
    L = native.lib()
    _lk, lensp, nlens = native.u32_buf(lens)
    cap = len(seq_buf) + 100
    out, outp = _out(cap)
    inp, _keep = _ptr(seq_buf)
    rc = L.fqz5_seq_encode(
        inp, len(seq_buf), lensp, nlens, both_strands, ctx_size,
        outp, cap)
    if rc < 0:
        raise ValueError("seq_encode failed")
    return native.take(out, rc)


def seq_decode(comp: bytes, lens, both_strands: int, ctx_size: int,
               out_size: int) -> bytes:
    L = native.lib()
    _lk, lensp, nlens = native.u32_buf(lens)
    out, outp = native.fresh_out(out_size)
    inp, _keep = _ptr(comp)
    rc = L.fqz5_seq_decode(
        inp, len(comp), lensp, nlens, both_strands, ctx_size,
        outp, out_size)
    if rc < 0:
        raise ValueError("seq_decode failed")
    return native.seal_out(out, out_size)


def fqz_compress(qual: bytes, lens, flags, seq_buf: bytes | None,
                 strat: int) -> bytes:
    """Compress qualities (already rebased to q-33)."""
    from array import array

    L = native.lib()
    _lk, lensp, nlens = native.u32_buf(lens)
    # mutated by stats; pass a copy
    flags_copy = (flags.astype("uint32") if hasattr(flags, "astype")
                  else array("I", flags))
    _fk, flagsp, _ = native.u32_buf(flags_copy)
    cap = int(len(qual) * 1.1) + 100000
    out, outp = _out(cap)
    inp, _keep = _ptr(qual)
    if seq_buf is None:
        seqp = ctypes.cast(0, _u8p)
        _keep2 = None
    else:
        seqp, _keep2 = _ptr(seq_buf)
    rc = L.fqz5_fqz_compress(
        inp, len(qual), lensp, flagsp, seqp, nlens, strat, outp, cap)
    if rc < 0:
        raise ValueError("fqz_compress failed")
    return native.take(out, rc)


def fqz_decompress(comp: bytes, out_size: int,
                   seq_buf: bytes | None = None) -> bytes:
    L = native.lib()
    out, outp = native.fresh_out(out_size)
    inp, _keep = _ptr(comp)
    if seq_buf is None:
        seqp = ctypes.cast(0, _u8p)
        _keep2 = None
    else:
        seqp, _keep2 = _ptr(seq_buf)
    rc = L.fqz5_fqz_decompress(inp, len(comp), outp, out_size, seqp)
    if rc < 0:
        raise ValueError("fqz_decompress failed")
    return native.seal_out(out, rc)


def lzp(data: bytes) -> bytes:
    L = native.lib()
    cap = len(data) * 2 + 1024
    out, outp = _out(cap)
    inp, _keep = _ptr(data)
    rc = L.fqz5_lzp(inp, len(data), outp, cap)
    if rc < 0:
        raise ValueError("lzp failed")
    return native.take(out, rc)


def unlzp(data: bytes, out_size: int) -> bytes:
    L = native.lib()
    out, outp = native.fresh_out(out_size)
    inp, _keep = _ptr(data)
    rc = L.fqz5_unlzp(inp, len(data), outp, out_size)
    if rc < 0:
        raise ValueError("unlzp failed")
    return native.seal_out(out, rc)


def arith_compress(data: bytes, order: int) -> bytes:
    L = native.lib()
    cap = int(1.05 * len(data)) + 257 * 257 * 3 + 1024
    out, outp = _out(cap)
    inp, _keep = _ptr(data)
    rc = L.fqz5_arith_compress(inp, len(data), order, outp, cap)
    if rc < 0:
        raise ValueError("arith_compress failed")
    return native.take(out, rc)


def arith_uncompress(data: bytes) -> bytes:
    from fqzcomp5_tpu_torch.utils import varint

    L = native.lib()
    if data[0] & 0x10:
        raise ValueError("NOSZ arith stream needs explicit size")
    osz, _ = varint.get_u32(data, 1)
    out, outp = _out(osz + 64)
    inp, _keep = _ptr(data)
    rc = L.fqz5_arith_uncompress(inp, len(data), outp, osz + 64)
    if rc < 0:
        raise ValueError("arith_uncompress failed")
    return native.take(out, rc)


def tok3_encode(names_blk: bytes, level: int, use_arith: int) -> bytes:
    """names_blk: \\0- or \\n-separated names, trailing separator included."""
    L = native.lib()
    cap = len(names_blk) * 2 + (1 << 16)
    out, outp = _out(cap)
    inp, _keep = _ptr(names_blk)
    rc = L.fqz5_tok3_encode(inp, len(names_blk), level, use_arith, outp, cap)
    if rc < 0:
        raise ValueError("tok3_encode failed")
    return native.take(out, rc)


def tok3_decode(comp: bytes, expected_len: int | None = None,
                max_len: int | None = None) -> bytes:
    """expected_len: the section's known uncompressed size (exact);
    max_len: an upper bound from the framing.  Either fails fast on a
    corrupt embedded length instead of decoding gigabytes."""
    L = native.lib()
    if len(comp) < 9:
        raise ValueError("short tok3 stream")
    ulen = int.from_bytes(comp[:4], "little")
    if expected_len is not None and ulen != expected_len:
        raise ValueError(
            f"tok3 length mismatch: stream says {ulen}, "
            f"section says {expected_len}")
    if max_len is not None and ulen > max_len:
        raise ValueError("tok3 length exceeds section bound")
    if expected_len is None and ulen > (1 << 28):
        raise ValueError("implausible tok3 uncompressed length")
    cap = ulen + 2048
    out, outp = _out(cap)
    inp, _keep = _ptr(comp)
    rc = L.fqz5_tok3_decode(inp, len(comp), outp, cap)
    if rc < 0:
        raise ValueError("tok3_decode failed")
    return native.take(out, rc)
