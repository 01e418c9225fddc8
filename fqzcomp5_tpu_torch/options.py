"""Encoder/decoder options and the -1..-9 preset bundles.

Mirrors the reference `opts` struct (fqzcomp5.c:1799-1813), its
defaults (fqzcomp5.c:4748-4770), and the preset method bitmasks
(fqzcomp5.c:4886-4932).
"""

from __future__ import annotations

from fqzcomp5_tpu_torch.utils import lightclass as dataclasses  # noqa: N813 — see lightclass.py

from fqzcomp5_tpu_torch.constants import DEFAULT_BLOCK_SIZE, Method, bit


@dataclasses.dataclass
class Options:
    qstrat: int = 1   # 0=rans, 1=fqz
    qlevel: int = 0
    sstrat: int = 1   # 0=rans, 1=seq-context model
    slevel: int = 12  # seq context order (4^12)
    scustom: int = 0
    nstrat: int = 2   # (0=rans), 1=tok3, 2=tok3 + comments
    nlevel: int = 5
    qauto: int = (
        bit(Method.RANS0) | bit(Method.RANS1) | bit(Method.RANS129)
        | bit(Method.RANS193) | bit(Method.FQZ0) | bit(Method.FQZ1)
    )
    sauto: int = (
        bit(Method.RANS0) | bit(Method.RANS1) | bit(Method.RANS129)
        | bit(Method.RANS193) | bit(Method.SEQ10) | bit(Method.SEQ12B)
    )
    nauto: int = bit(Method.TLZP3) | bit(Method.TOK3_5_LZP)
    both_strands: int = 0
    verbose: int = 0
    blk_size: int = DEFAULT_BLOCK_SIZE
    nthread: int = 4
    plus_name: int = 0
    check_only: int = 0
    inspect_only: int = 0
    verify_crc: int = 1
    paired_mode: int = 0
    # TPU-framework extensions (not part of the reference CLI)
    engine: str = "cuda"  # cuda | host
    # decode each device-encoded adaptive payload back through the
    # native decoder (FQZ5_DEVICE_ADAPTIVE_VERIFY; blocks.py)
    verify_device: int = 0

    def apply_preset(self, level: int) -> None:
        """Apply a -1/-3/-5/-7/-9 preset (fqzcomp5.c:4886-4932)."""
        R = (
            bit(Method.RANS0) | bit(Method.RANS1)
            | bit(Method.RANS129) | bit(Method.RANS193)
        )
        if level == 1:
            self.nauto = bit(Method.TLZP3)
            self.sauto = R | bit(Method.LZP3)
            self.qauto = R
            self.blk_size = 10_000_000
        elif level == 3:
            self.nauto = bit(Method.TLZP3) | bit(Method.TOK3_3_LZP)
            self.sauto = R | bit(Method.LZP3)
            self.qauto = R | bit(Method.RANSXN1)
            self.blk_size = 100_000_000
        elif level == 5:
            self.nauto = bit(Method.TLZP3) | bit(Method.TOK3_5_LZP)
            self.sauto = R | bit(Method.LZP3) | bit(Method.SEQ10) | bit(Method.SEQ12B)
            self.qauto = R | bit(Method.RANSXN1) | bit(Method.FQZ1) | bit(Method.FQZ3)
            self.blk_size = 100_000_000
        elif level == 7:
            self.nauto = (
                bit(Method.TLZP3) | bit(Method.TOK3_7_LZP) | bit(Method.TOK3_7)
            )
            self.sauto = (
                R | bit(Method.LZP3) | bit(Method.RANS65)
                | bit(Method.SEQ10) | bit(Method.SEQ12B) | bit(Method.SEQ13B)
            )
            self.qauto = (
                R | bit(Method.RANS65) | bit(Method.FQZ0) | bit(Method.FQZ1)
                | bit(Method.FQZ2) | bit(Method.FQZ3) | bit(Method.FQZ4)
            )
            self.blk_size = 500_000_000
        elif level == 9:
            self.nauto = (
                bit(Method.TLZP3) | bit(Method.TOK3_9_LZP) | bit(Method.TOK3_9)
            )
            self.sauto = (
                R | bit(Method.RANS64) | bit(Method.RANS65)
                | bit(Method.RANS128) | bit(Method.RANS129)
                | bit(Method.LZP3) | bit(Method.SEQ10) | bit(Method.SEQ12)
                | bit(Method.SEQ12B) | bit(Method.SEQ13B) | bit(Method.SEQ14B)
            )
            self.qauto = (
                R | bit(Method.RANS64) | bit(Method.RANS65)
                | bit(Method.RANS128) | bit(Method.RANS129)
                | bit(Method.FQZ0) | bit(Method.FQZ1) | bit(Method.FQZ2)
                | bit(Method.FQZ3) | bit(Method.FQZ4)
            )
            self.blk_size = 1_000_000_000
        else:
            raise ValueError(f"no preset level {level}")

    def clamp_block_size(self) -> None:
        """K/M/G-suffixed sizes clamp to [1MB, 2GB] (fqzcomp5.c:4870-4884)."""
        self.blk_size = max(1_000_000, min(2_000_000_000, self.blk_size))


def method_avail_for(arg: Options) -> list[int]:
    """Compute per-section allowed-method bitmasks.

    Mirrors the driver setup in encode_gzip (fqzcomp5.c:2995-3038).
    Returns [name_mask, len_mask(unused), seq_mask, qual_mask].
    """
    from fqzcomp5_tpu_torch.constants import RANS_METHODS

    name_mask = 0
    if arg.nauto:
        name_mask = arg.nauto
    else:
        if arg.nstrat == 1:
            name_mask |= 1 << (int(Method.TOK3_3) + arg.nlevel // 2 - 1)
        elif arg.nstrat == 2:
            name_mask |= 1 << (int(Method.TOK3_3_LZP) + arg.nlevel // 2 - 1)
        else:
            name_mask = bit(Method.TLZP3)

    if arg.scustom:
        seq_mask = bit(Method.SEQ_CUSTOM)
    else:
        seq_mask = 0
        if arg.sauto:
            seq_mask = arg.sauto
        elif arg.sstrat == 1:
            seq_mask = bit(Method.SEQ_CUSTOM)
        if not seq_mask:
            seq_mask = RANS_METHODS

    if arg.qauto:
        qual_mask = arg.qauto
    else:
        if arg.qstrat == 1:
            qlevel_to_m = {
                4: Method.FQZ4, 3: Method.FQZ3, 2: Method.FQZ2, 1: Method.FQZ1,
            }
            # NB: the reference assigns the method *number* (not a bit)
            # here (fqzcomp5.c:3024-3034); we reproduce that quirk so the
            # selected method matches. A bare number < M_LAST acts as a
            # small bitmask of low-numbered methods.
            qual_mask = int(qlevel_to_m.get(arg.qlevel, Method.FQZ0))
        else:
            qual_mask = RANS_METHODS

    return [name_mask, 0, seq_mask, qual_mask]
