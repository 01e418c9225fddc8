"""Big-endian base-128 varints, wire-compatible with htscodecs.

Format (htscodecs/varint.h:60-130): most-significant group first, the
continuation bit (0x80) set on every byte except the last.
"""

from __future__ import annotations

from fqzcomp5_tpu_torch.utils.lazy_np import np


def put_u64(value: int) -> bytes:
    """Encode one unsigned integer (htscodecs varint.h var_put_u64)."""
    if value < 0:
        raise ValueError("varint must be non-negative")
    groups = [value & 0x7F]
    value >>= 7
    while value:
        groups.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(groups))


put_u32 = put_u64


def get_u32(buf, off: int = 0) -> tuple[int, int]:
    """Decode one u32-capped varint. Returns (value, bytes_consumed).

    Mirrors var_get_u32 (varint.h:267-290): at most 5 continuation
    bytes are honoured.
    """
    j = 0
    n = 5
    start = off
    while True:
        c = buf[off]
        off += 1
        j = ((j << 7) | (c & 0x7F)) & 0xFFFFFFFF
        if not (c & 0x80) or n <= 0:
            break
        n -= 1
    return j, off - start


def get_u64(buf, off: int = 0) -> tuple[int, int]:
    j = 0
    n = 10
    start = off
    while True:
        c = buf[off]
        off += 1
        j = (j << 7) | (c & 0x7F)
        if not (c & 0x80) or n <= 0:
            break
        n -= 1
    return j, off - start


def put_array_u32(values) -> bytes:
    """Vectorised encode of many u32 varints (used for length streams).

    The native C walk keeps the encode CLI numpy-free; the numpy
    formulation below is the fallback when the library is unavailable.
    """
    n = len(values)
    if n:
        try:
            from fqzcomp5_tpu_torch.codecs import native

            L = native.lib()
            _vk, vp, cnt = native.u32_buf(values)
            out, outp = native.fresh_out(5 * cnt)
            w = L.fqz5_varint_put_u32_array(vp, cnt, outp)
            return native.seal_out(out, int(w))
        except (OSError, AttributeError):
            pass  # library missing/stale: numpy fallback below
    v = np.asarray(values, dtype=np.uint64)
    if v.size == 0:
        return b""
    # Number of 7-bit groups per value (at least 1)
    nbits = np.zeros(v.shape, dtype=np.int64)
    tmp = v.copy()
    nz = tmp > 0
    while nz.any():
        nbits[nz] += 1
        tmp >>= np.uint64(7)
        nz = tmp > 0
    ngroups = np.maximum(nbits, 1)
    total = int(ngroups.sum())
    out = np.empty(total, dtype=np.uint8)
    ends = np.cumsum(ngroups)  # one past last byte of each value
    # Fill bytes from least-significant group backwards.
    max_g = int(ngroups.max())
    rem = v.copy()
    for g in range(max_g):
        pos = ends - 1 - g
        active = ngroups > g
        byte = (rem & np.uint64(0x7F)).astype(np.uint8)
        if g > 0:
            byte |= 0x80
        out[pos[active]] = byte[active]
        rem >>= np.uint64(7)
    return out.tobytes()


def get_array_u32(buf, off: int, count: int):
    """Decode `count` consecutive u32 varints.

    Returns (values, new_offset).  The native C walk returns a stdlib
    array('I') and keeps the decode CLI path numpy-free (cold-start:
    numpy is ~300ms); the numpy formulation below is the fallback when
    the native library is unavailable.
    """
    from array import array

    if count == 0:
        return array("I"), off
    try:
        from fqzcomp5_tpu_torch.codecs import native

        L = native.lib()
        vals = array("I", bytes(4 * count))
        _vk, vp, _ = native.u32_buf(vals)
        _bk, bp = native._u8(buf)
        end = L.fqz5_varint_get_u32_array(bp, len(buf), off, count, vp)
        if end < 0:
            raise ValueError("truncated varint stream")
        return vals, int(end)
    except (OSError, AttributeError):
        pass  # library missing/stale: numpy fallback below
    data = np.frombuffer(buf, dtype=np.uint8)
    # Terminator bytes have the top bit clear.  u32 varints are at most
    # 6 bytes, so only a bounded window needs scanning (not the whole
    # remaining buffer).
    window = min(len(data), off + count * 6 + 8)
    is_end = (data[off:window] & 0x80) == 0
    ends_rel = np.flatnonzero(is_end)
    if ends_rel.size < count:
        raise ValueError("truncated varint stream")
    ends = ends_rel[:count] + off  # index of last byte of each varint
    starts = np.empty(count, dtype=np.int64)
    starts[0] = off
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if (lengths > 5).any():
        # Reference caps u32 decode at 6 bytes; fall back to scalar path
        vals = np.empty(count, dtype=np.uint32)
        o = off
        for i in range(count):
            vals[i], n = get_u32(buf, o)
            o += n
        return vals, o
    vals = np.zeros(count, dtype=np.uint64)
    max_len = int(lengths.max())
    for k in range(max_len):
        pos = starts + k
        active = lengths > k
        b = data[pos[active]].astype(np.uint64)
        vals[active] = (vals[active] << np.uint64(7)) | (b & np.uint64(0x7F))
    return vals.astype(np.uint32), int(ends[-1] + 1)
