"""Block encoder/decoder: per-section codec trials + FQZ5 block framing.

Wire-compatible with encode_block/decode_block (fqzcomp5.c:2147-2547).
Block layout (v1.1):
  [u32 block_size][u32 nrec][u32 crc32]
  names   [u32 ulen][u8 strat][u32 clen][payload]
  lengths fixed: [u8 nbytes][varint len] / var: [u8 0][u32 size][varints]
  seq     [u8 strat][u32 ulen][u32 clen][payload]
  qual    [u8 strat][u32 ulen][u32 clen][payload]   (0/0/0 for FASTA)

The adaptive codecs (SEQ*, SEQ_CUSTOM, FQZ*) run the native host codecs,
or, when encode_block is given a device (the CLI's -e host with
FQZ5_DEVICE_ADAPTIVE set), encode each section as one job of the
three-pass device decomposition on it (ops/seq_device_encode,
ops/fqz_device_encode): the same bytes, except that a SEQ payload over
the host codec's cap of len + 100 is kept.  A device error propagates;
nothing falls back to the host codecs.  With arg.verify_device set,
each device payload is decoded back through the native decoder first.
"""

from __future__ import annotations

import struct
import sys
import zlib
from typing import TYPE_CHECKING

from fqzcomp5_tpu_torch.utils.lazy_np import np

from fqzcomp5_tpu_torch import names as names_mod
from fqzcomp5_tpu_torch.utils import varint
from fqzcomp5_tpu_torch.codecs import host
from fqzcomp5_tpu_torch.constants import Method, Section, VERS_V11
from fqzcomp5_tpu_torch.fastq import FastqBatch
from fqzcomp5_tpu_torch.learning import MethodLearner
from fqzcomp5_tpu_torch.options import Options

if TYPE_CHECKING:  # the host codecs' route imports no torch
    import torch

    from fqzcomp5_tpu_torch.mesh import Mesh

# rANS order per RANS* method (fqzcomp5.c:1994)
_RANS_ORDERS = {
    Method.RANS0: 0, Method.RANS1: 1, Method.RANS64: 64, Method.RANS65: 65,
    Method.RANS128: 128, Method.RANS129: 129, Method.RANS192: 192,
    Method.RANS193: 193,
}

_SEQ_PARAMS = {  # slevel, both_strands (fqzcomp5.c:2048-2056)
    Method.SEQ10: (10, 0), Method.SEQ12: (12, 0), Method.SEQ12B: (12, 1),
    Method.SEQ13B: (13, 1), Method.SEQ14B: (14, 1),
}

_TOK3_LEVEL = {  # (m - TOK3_3) * 2 + 3
    Method.TOK3_3: 3, Method.TOK3_5: 5, Method.TOK3_7: 7, Method.TOK3_9: 9,
    Method.TOK3_3_LZP: 3, Method.TOK3_5_LZP: 5, Method.TOK3_7_LZP: 7,
    Method.TOK3_9_LZP: 9,
}


def _decodes_back(decode, data: bytes) -> bool:
    """Whether decode() gives data back (a decoder error is a no)."""
    try:
        return decode() == data
    except ValueError:
        return False


def _seq_encode(data: bytes, lens, both: int, slevel: int, arg: Options,
                device):
    """The SEQ payload, on the host, or on `device` when one is given;
    None where the host codec overflows its cap."""
    if device is None:
        try:
            return host.seq_encode(data, lens, both, slevel)
        except ValueError:
            return None  # coder overflowed its cap on adversarial input
    from fqzcomp5_tpu_torch.ops import seq_device_encode

    out = seq_device_encode.encode_payload(data, lens, both, slevel, device)
    if arg.verify_device and not _decodes_back(
            lambda: host.seq_decode(out, lens, both, slevel, len(data)),
            data):
        raise ValueError("device SEQ payload failed native decode-back")
    return out


def _fqz_compress(data: bytes, fq: FastqBatch, strat_n: int, arg: Options,
                  device):
    """The fqz payload, on the host, or on `device` when one is given;
    None where the codec declines the block."""
    if device is None:
        try:
            return host.fqz_compress(data, fq.lens, fq.flags, fq.seq_buf,
                                     strat_n)
        except ValueError:
            # codec declined (e.g. >96-symbol quality alphabet, where
            # the reference corrupts its heap); the reference treats a
            # NULL codec return as out_len=UINT_MAX — method skipped
            return None
    from fqzcomp5_tpu_torch.ops import fqz_device_encode

    out = fqz_device_encode.fqz_compress_device(
        data, fq.lens, fq.flags, fq.seq_buf, strat_n, device)
    if out is not None and arg.verify_device and not _decodes_back(
            lambda: host.fqz_decompress(out, len(data), seq_buf=fq.seq_buf),
            data):
        raise ValueError("device FQZ payload failed native decode-back")
    return out


def _compress_one(m: int, arg: Options, fq: FastqBatch, sec: int,
                  data: bytes, device: torch.device | Mesh | None = None):
    """Run one codec method; returns (payload, strat) or None on N/A.
    device: where the adaptive codecs encode (None: the host codecs)."""
    m = Method(m)
    if m in _RANS_ORDERS:
        return host.rans_compress(data, _RANS_ORDERS[m]), 0
    if m == Method.RANSXN1:
        if not fq.fixed_len:
            return None
        return host.rans_compress(data, (fq.fixed_len << 8) + 9), 0
    if m == Method.LZP3:
        lz = host.lzp(data)
        return host.rans_compress(lz, 5), int(Method.LZP3)
    if m == Method.TLZP3:
        return names_mod.encode_names(data, 0, 3), -1  # strat inside payload
    if m in (Method.TOK3_3, Method.TOK3_5, Method.TOK3_7, Method.TOK3_9):
        return names_mod.encode_names(data, 1, _TOK3_LEVEL[m]), -1
    if m in (Method.TOK3_3_LZP, Method.TOK3_5_LZP, Method.TOK3_7_LZP,
             Method.TOK3_9_LZP):
        return names_mod.encode_names(data, 2, _TOK3_LEVEL[m]), -1
    if m in _SEQ_PARAMS or m == Method.SEQ_CUSTOM:
        slevel, both = _SEQ_PARAMS.get(m, (arg.slevel, arg.both_strands))
        out = _seq_encode(data, fq.lens, both, slevel, arg, device)
        return None if out is None else (
            out, (slevel << 4) | (both << 3) | 1)
    if m in (Method.FQZ0, Method.FQZ1, Method.FQZ2, Method.FQZ3,
             Method.FQZ4):
        out = _fqz_compress(data, fq, int(m) - int(Method.FQZ0), arg,
                            device)
        return None if out is None else (out, 1)
    raise ValueError(f"unsupported method {m}")


def compress_with_methods(learner: MethodLearner, arg: Options,
                          fq: FastqBatch, methods: int, sec: int,
                          data: bytes,
                          device: torch.device | Mesh | None = None):
    """Try each allowed method, keep the smallest (fqzcomp5.c:1961-2144).

    Returns (payload, strat, method_used)."""
    in_trial = learner.in_trial(sec)
    best = None
    best_strat = 0
    best_m = 0
    sizes = {}
    for m in range(1, 31):
        if not (methods & (1 << m)):
            continue
        r = _compress_one(m, arg, fq, sec, data, device)
        if r is None:
            sizes[m] = (len(data), (1 << 32) - 1)  # mirrors out_len=UINT_MAX
            continue
        out, strat = r
        sizes[m] = (len(data), len(out))
        if arg.verbose > 2:
            secstr = ["name", "length", "sequence", "quality"]
            import sys
            print(f"Try      {secstr[sec]:>8s} with method {m:2d} "
                  f"{len(data):10d} to {len(out):10d} bytes",
                  file=sys.stderr)
        if best is None or len(out) < len(best):
            best = out
            best_strat = strat
            best_m = m
    if best is None:
        raise ValueError(f"no method produced output for section {sec}")
    if in_trial:
        learner.record_trial(sec, sizes)
    return best, best_strat, best_m


def encode_block(learner: MethodLearner, arg: Options, fq: FastqBatch,
                 timings=None,
                 device: torch.device | Mesh | None = None) -> bytes:
    """One block's bytes.  device: where the adaptive codecs encode (a
    torch.device or a Mesh; None: the host codecs)."""
    import time

    out = bytearray()
    out += struct.pack("<I", 0)  # block size placeholder
    out += struct.pack("<I", fq.num_records)
    out += struct.pack("<I", 0)  # crc placeholder

    # Names (payload already carries [ulen][strat][clen] framing)
    tv = time.monotonic()
    methods = learner.methods_for(Section.NAME)
    npay, _, nmeth = compress_with_methods(
        learner, arg, fq, methods, Section.NAME, fq.name_buf)
    out += npay
    if timings is not None:
        timings.update(0, len(fq.name_buf), len(npay), time.monotonic() - tv)
        timings.nmeth = nmeth

    # Lengths
    if fq.fixed_len:
        v = varint.put_u32(fq.fixed_len)
        out += bytes([len(v)]) + v
        if timings is not None:
            timings.update(3, 4 * fq.num_records, 1 + len(v), 0.0)
            timings.lmeth = 1
    else:
        lens_blob = varint.put_array_u32(fq.lens)
        out += bytes([0]) + struct.pack("<I", len(lens_blob)) + lens_blob
        if timings is not None:
            timings.update(3, 4 * fq.num_records, 5 + len(lens_blob), 0.0)
            timings.lmeth = 0

    # Seq
    tv = time.monotonic()
    methods = learner.methods_for(Section.SEQ)
    spay, sstrat, smeth = compress_with_methods(
        learner, arg, fq, methods, Section.SEQ, fq.seq_buf, device)
    out += struct.pack("<BII", sstrat, len(fq.seq_buf), len(spay)) + spay
    if timings is not None:
        timings.update(1, len(fq.seq_buf), len(spay) + 9,
                       time.monotonic() - tv)
        timings.smeth = smeth

    # Qual
    if not fq.is_fasta:
        tv = time.monotonic()
        methods = learner.methods_for(Section.QUAL)
        qpay, qstrat, qmeth = compress_with_methods(
            learner, arg, fq, methods, Section.QUAL, fq.qual_buf, device)
        out += struct.pack("<BII", qstrat, len(fq.qual_buf), len(qpay)) + qpay
        if timings is not None:
            timings.update(2, len(fq.qual_buf), len(qpay) + 9,
                           time.monotonic() - tv)
            timings.qmeth = qmeth
    else:
        out += struct.pack("<BII", 0, 0, 0)

    crc = zlib.crc32(bytes(out[12:])) & 0xFFFFFFFF
    struct.pack_into("<I", out, 8, crc)
    struct.pack_into("<I", out, 0, len(out) - 4)
    return bytes(out)


def decode_block(raw: bytes, file_version: int,
                 predecoded: dict | None = None,
                 timings=None) -> FastqBatch:
    """predecoded: optional {'seq': bytes, 'qual': bytes} payloads that
    were already expanded (e.g. by the batched device decoder).

    timings: optional per-block Timings; filled with the decode-side
    accounting (sizes swapped compressed->uncompressed, framing bytes
    excluded — fqzcomp5.c decode_block)."""
    import time
    off = 0
    (block_size,) = struct.unpack_from("<I", raw, off)
    off += 4
    (nrec,) = struct.unpack_from("<I", raw, off)
    off += 4
    if file_version == VERS_V11:
        (stored_crc,) = struct.unpack_from("<I", raw, off)
        off += 4
        crc = zlib.crc32(raw[off:off + block_size - 8]) & 0xFFFFFFFF
        if crc != stored_crc:
            raise ValueError(
                f"Block CRC mismatch! expected {stored_crc:#010x} "
                f"got {crc:#010x}")

    # Names
    tv = time.monotonic()
    (u_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    nstrat = raw[off]
    off += 1
    (c_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    name_buf, dec_flags = names_mod.decode_names(
        raw[off:off + c_len], c_len, u_len, nstrat)
    off += c_len
    if timings is not None:
        timings.update(0, c_len, u_len, time.monotonic() - tv)

    # Every decoded name ends in a NUL, so a valid block has
    # nrec <= len(name_buf); a corrupt header nrec (e.g. 2^30) would
    # otherwise drive gigabyte flag/length allocations below.
    if nrec > len(name_buf):
        raise ValueError("record count exceeds decoded name buffer")

    # Per-record flags: from the strat-2 stream or re-derived from names
    if dec_flags is not None and len(dec_flags) >= nrec:
        flags = dec_flags[:nrec]
    else:
        from fqzcomp5_tpu_torch.codecs import native
        flags = native.derive_flags(name_buf, nrec)

    # Lengths
    lstrat = raw[off]
    off += 1
    if lstrat > 0:
        fixed, n = varint.get_u32(raw, off)
        off += n
        from array import array
        lens = array("I", [fixed]) * nrec
        fixed_len = fixed
        if timings is not None:
            timings.update(3, 1 + n, nrec * 4, 0.0)
    else:
        (blen,) = struct.unpack_from("<I", raw, off)
        off += 4
        lens, off = varint.get_array_u32(raw, off, nrec)
        fixed_len = 0
        if timings is not None:
            timings.update(3, blen + 5, nrec * 4, 0.0)

    # Seq
    tv = time.monotonic()
    sstrat = raw[off]
    off += 1
    (s_ulen, s_clen) = struct.unpack_from("<II", raw, off)
    off += 8
    spay = raw[off:off + s_clen]
    off += s_clen
    if predecoded and "seq" in predecoded:
        seq_buf = predecoded["seq"]
    elif (sstrat & 7) == 1:
        slevel = sstrat >> 4
        both = (sstrat >> 3) & 1
        seq_buf = host.seq_decode(spay, lens, both, slevel, s_ulen)
    elif sstrat == int(Method.LZP3):
        rout = host.rans_uncompress(spay)
        seq_buf = host.unlzp(rout, s_ulen)
    elif sstrat == 0:
        seq_buf = host.rans_uncompress(spay)
    else:
        raise ValueError(f"unrecognised sequence strategy {sstrat}")
    if timings is not None:
        timings.update(1, s_clen, s_ulen, time.monotonic() - tv)

    # Qual
    tv = time.monotonic()
    qstrat = raw[off]
    off += 1
    (q_ulen, q_clen) = struct.unpack_from("<II", raw, off)
    off += 8
    if q_ulen == 0 and q_clen == 0:
        qual_buf = b""
        is_fasta = True
    else:
        qpay = raw[off:off + q_clen]
        off += q_clen
        is_fasta = False
        if predecoded and "qual" in predecoded:
            qual_buf = predecoded["qual"]
        elif qstrat == 0:
            qual_buf = host.rans_uncompress(qpay)
        else:
            qual_buf = host.fqz_decompress(qpay, q_ulen, seq_buf)
        if timings is not None:
            timings.update(2, q_clen, len(qual_buf), time.monotonic() - tv)

    return FastqBatch(
        name_buf=name_buf, seq_buf=seq_buf, qual_buf=qual_buf,
        lens=lens, flags=flags,
        fixed_len=fixed_len, is_fasta=is_fasta)
