"""How far a 128-key softmax walk lies from the 64-key walk of the dense
flash forward in bf16 (CPU, about ten seconds).

    python3 tools/fwd_tile_gap.py

The forward rounds P to bf16 against the running max after every tile of
keys, so the tile size is part of its rounding schedule. For each shape
(few heads, seeded, q pre-scaled as the kernels take it) this runs
``flash_fwd_plain`` at ``block_k`` 128 and 64 and prints o's gap under
chip_smoke's flash rule: the worst excess over the elementwise limit
2^-6 (|ref| + row max + rms) (<= 0 passes) and the relative Frobenius
error (limit 2^-10 = 9.77e-4). A gap past the Frobenius limit means a
kernel with 128-key softmax tiles could not be held to the 64-key plain
version, nor the other way round; that is why the bf16 kernel loads
128-key stages but runs its softmax and P.V per 64-key half.
"""
from __future__ import annotations

import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import flash_close  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (BH, Sq, Sk, D, causal): the train shape's S and D, the generate
# prefill's and the ERNIE step's (few heads), and a non-causal one
SHAPES = [(4, 2048, 2048, 128, True), (4, 1024, 1024, 64, True),
          (4, 512, 512, 64, True), (4, 1024, 1024, 64, False),
          (8, 200, 200, 128, True)]


def main():
    torch.manual_seed(0)
    print(f"bf16; limits: elementwise excess <= 0, rel frob <= {2 ** -10:.3e}")
    for i, (bh, sq, sk, d, causal) in enumerate(SHAPES):
        g = torch.Generator().manual_seed(i)
        qs = (torch.randn((bh, sq, d), generator=g)
              * (fa.LOG2E / math.sqrt(d))).to(torch.bfloat16)
        k, v = (torch.randn((bh, sk, d), generator=g).to(torch.bfloat16)
                for _ in range(2))
        o128, lse128 = fa.flash_fwd_plain(qs, k, v, causal, block_k=128)
        o64, lse64 = fa.flash_fwd_plain(qs, k, v, causal, block_k=64)
        _, excess, fro, err = flash_close(o128, o64, 2 ** -6, 2 ** -10)
        print(f"BH={bh} Sq={sq} Sk={sk} D={d} causal={causal}: o rel frob "
              f"{fro:.3e} ({'over' if fro > 2 ** -10 else 'within'} the "
              f"limit), worst excess {excess:.3e}, max abs {err:.3e}; lse "
              f"max abs {(lse128 - lse64).abs().max().item():.2e}")


if __name__ == "__main__":
    main()
