#!/usr/bin/env python3
"""Times the port's TinyModel walk (model_cuda.tiny_evolve) at -5's
logged launch shapes of T <= 1,024 and around the layout switch, for the
fqzcomp5_tpu_torch package under DIR, on the card (H100):

    python3 tools/tiny_layout_grid.py DIR

Run from the repository root.  To compare the two layouts of
csrc/fqz_evolve.cu, copy the package twice and set kTinyThreadMinC to 0
(thread layout everywhere) in one copy and to 1 << 30 (warp layout
everywhere) in the other, then run this on both in one call, in turns.
Symbols are random bases and counts fall in (T/4, T] (1..16 at T = 16),
as in -5's count buckets; each shape is timed over 10 launches with CUDA
events."""

import os
import sys

DIR = os.path.abspath(sys.argv[1])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [DIR, ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from fqzcomp5_tpu_torch.ops import model_cuda  # noqa: E402

# -5's TinyModel launches of T <= 1,024 (chip_smoke.LaunchShapes), then a
# grid around the switch
SHAPES = [(154739, 16), (2294569, 16), (1391504, 16), (774073, 64),
          (3735416, 64), (1958141, 64), (560449, 256), (260281, 256),
          (35676, 256), (2808, 1024), (4086, 1024), (768, 1024)]
SHAPES += [(c, t) for t in (16, 64, 256) for c in (4096, 16384, 65536)]


def main() -> int:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for C, T in SHAPES:
        ct = rng.integers(T // 4 + 1 if T > 16 else 1, T + 1, C).astype(
            np.int32)
        sp = torch.randint(0, 4, (C, T), device=dev, dtype=torch.uint8,
                           generator=g)
        c = torch.from_numpy(ct).to(dev)
        ms, _ = chip_smoke._time(lambda: model_cuda.tiny_evolve(sp, c, 4), 10)
        print(f"grid {sys.argv[1]} C={C} T={T} steps={int(ct.sum())}: "
              f"{ms:.4f} ms", flush=True)
        del sp
    return 0


if __name__ == "__main__":
    sys.exit(main())
