"""Read-name section codec: the 3-strategy wrapper.

Wire-compatible with encode_names/decode_names (fqzcomp5.c:1408-1794):

strategy 0: LZP, then rANS order 5 (O1|X32)
strategy 1: tok3 over the whole name block
strategy 2: names split into ID + flags + comment streams --
            ID via tok3, per-record flag bytes via rANS order 129,
            comments via LZP + rANS order 5.

Framing: [u32 ulen][u8 strat][u32 clen][payload]; strategy 2's payload
is [u32 clen1][u32 clenf][tok3][flags][comments].
"""

from __future__ import annotations

import struct

from fqzcomp5_tpu_torch.utils.lazy_np import np

from fqzcomp5_tpu_torch.codecs import host
from fqzcomp5_tpu_torch.constants import FQZ_FREAD2


def encode_names(name_buf: bytes, strat: int, level: int) -> bytes:
    ulen = len(name_buf)
    if strat == 0:
        lz = host.lzp(name_buf)
        comp = host.rans_compress(lz, 5)
        return struct.pack("<IBI", ulen, 0, len(comp)) + comp

    if strat == 1:
        comp = host.tok3_encode(name_buf, level, 0)
        return struct.pack("<IBI", ulen, 1, len(comp)) + comp

    # strategy 2: split ID / flag / comment (native single pass;
    # fqz5_split_names in native/hostops.cpp).
    # NB deviation from the reference encoder: when any record has a
    # comment, comment-less records get an explicit EMPTY entry — the
    # reference encoder emits nothing for them, but its decoder
    # consumes one comment entry per record whenever a comment stream
    # exists, corrupting mixed blocks (fqzcomp5.c:1745-1749).  Ours
    # round-trips and stays reference-decodable.
    from fqzcomp5_tpu_torch.codecs import native

    ids, flags, comments = native.split_names(name_buf)

    out1 = host.tok3_encode(ids, level, 0)
    outf = host.rans_compress(flags, 129)
    out2 = b""
    if comments:
        lz = host.lzp(comments)
        out2 = host.rans_compress(lz, 5)

    clen = len(out1) + len(outf) + len(out2) + 8
    return (struct.pack("<IBI", ulen, 2, clen)
            + struct.pack("<II", len(out1), len(outf))
            + out1 + outf + out2)


def decode_names(comp: bytes, c_len: int, u_len: int, strat: int):
    """Returns (name_buf, flags_or_None).

    flags (per record, FQZ_FREAD2 semantics) are only recovered for
    strategy 2; the caller re-derives them from names otherwise
    (decode_block, fqzcomp5.c:2334-2374).
    """
    if strat == 0:
        rout = host.rans_uncompress(comp)
        return host.unlzp(rout, u_len), None
    if strat == 1:
        return host.tok3_decode(comp, expected_len=u_len), None

    clen1, clenf = struct.unpack_from("<II", comp, 0)
    if c_len < clen1 + clenf + 8:
        raise ValueError("invalid strat-2 name payload")
    clen2 = c_len - clen1 - clenf - 8
    # ids are the names minus suffixes/comments plus NULs: < 2x section
    out1 = host.tok3_decode(comp[8:8 + clen1], max_len=2 * u_len + 64)
    outf = host.rans_uncompress(comp[8 + clen1:8 + clen1 + clenf])
    out2 = b""
    if clen2:
        rout = host.rans_uncompress(comp[8 + clen1 + clenf:
                                         8 + clen1 + clenf + clen2])
        out2 = host.unlzp(rout, u_len)

    # Reference decode semantics (fqzcomp5.c:1722-1760): one ID per
    # record; a comment entry is consumed for EVERY record whenever a
    # comment stream exists (appended without separator if flag bit 2
    # is unset -- only reachable on reference-encoded mixed blocks).
    # Native single pass (fqz5_join_names).
    from fqzcomp5_tpu_torch.codecs import native

    name_buf, flags = native.join_names(out1, outf, out2)
    return name_buf, flags
