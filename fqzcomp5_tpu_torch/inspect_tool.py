"""--check and --inspect: container-level integrity and metadata walk.

Output text mirrors check_integrity (fqzcomp5.c:4609-4695) and
inspect_file (fqzcomp5.c:4345-4606) so scripted consumers keep working.
"""

from __future__ import annotations

import sys

from fqzcomp5_tpu_torch import container
from fqzcomp5_tpu_torch.constants import VERS_HEADERLESS, VERS_V10, VERS_V11


def check_integrity(fp, arg) -> int:
    file_version, index_offset = container.read_header(fp)
    if file_version != VERS_V11:
        print("Warning: File is version 1.0 or older (no CRC checksums)",
              file=sys.stderr)
        print("Cannot verify integrity - file has no checksums.",
              file=sys.stderr)
        return -1

    if arg.verbose >= 0:
        print("Checking file integrity...")

    nblocks = 0
    errors = 0
    for raw in container.iter_raw_blocks(fp, index_offset):
        s = container.summarize_block(raw, has_crc=True)
        nblocks += 1
        if not s.crc_ok:
            print(f"ERROR: CRC mismatch in block {nblocks}!", file=sys.stderr)
            errors += 1
        elif arg.verbose > 0:
            print(f"Block {nblocks}: CRC OK")

    if arg.verbose >= 0:
        if errors == 0:
            print(f"SUCCESS: All {nblocks} blocks verified OK")
        else:
            print(f"FAILED: {errors}/{nblocks} blocks had CRC errors")
    return -1 if errors else 0


def inspect_file(fp, arg) -> int:
    file_version, index_offset = container.read_header(fp)
    if file_version == VERS_V11:
        version_str = "1.1 (current)"
        has_crc = True
    elif file_version == VERS_V10:
        version_str = "1.0 (legacy)"
        has_crc = False
    else:
        version_str = "pre-1.0 (legacy, no header)"
        has_crc = False

    print("FQZ5 File Inspection")
    print("====================")
    print()
    print(f"Format Version:      {version_str}")

    pos = fp.tell()
    fp.seek(0, 2)
    file_size = fp.tell()
    fp.seek(pos)
    print(f"Compressed Size:     {file_size} bytes "
          f"({file_size / 1048576.0:.2f} MB)")

    nblocks = 0
    total_records = 0
    total_uncompressed = 0
    integrity_errors = 0
    for raw in container.iter_raw_blocks(fp, index_offset):
        s = container.summarize_block(raw, has_crc=has_crc)
        nblocks += 1
        total_records += s.nrecords
        if has_crc:
            if s.crc_ok is False:
                integrity_errors += 1
            total_uncompressed += (s.name_usize + s.seq_usize + s.qual_usize
                                   + s.nrecords * 5)

    idx = container.read_index(fp, index_offset) if index_offset else None

    print(f"Number of Blocks:    {nblocks}")
    if total_records:
        print(f"Total Records:       {total_records}")
    if total_uncompressed:
        ratio = total_uncompressed / file_size
        print(f"Uncompressed Size:   {total_uncompressed} bytes "
              f"({total_uncompressed / 1048576.0:.2f} MB)")
        print(f"Compression Ratio:   {ratio:.2f}x "
              f"({file_size * 100.0 / total_uncompressed:.2f}%)")
    if total_records:
        if total_records % 2 == 0:
            print("Interleaved:         Possibly "
                  "(even record count - heuristic)")
        else:
            print("Interleaved:         No (odd record count)")
    if idx:
        print(f"Index Present:       Yes ({idx.nblocks} blocks indexed)")
    else:
        print("Index Present:       No")

    print()
    print("Integrity Check:")
    if has_crc:
        if integrity_errors == 0:
            print(f"  Status:            OK (all {nblocks} blocks verified)")
        else:
            print(f"  Status:            FAILED ({integrity_errors}/{nblocks}"
                  " blocks have CRC errors)")
    else:
        print("  Status:            Not Available "
              "(file has no CRC checksums)")
        print("  Note:              Upgrade to v1.1 format for integrity "
              "checking")
    return -1 if integrity_errors else 0
