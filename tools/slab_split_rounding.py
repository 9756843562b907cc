"""Why the split slab decode seeds each split with the max of the scores
before it (CPU, a few seconds).

    python3 tools/slab_split_rounding.py

At the generate phase's decode shape (B 8, NH 32 over NKV 4, HD 64, T
1152, pos 1023, bf16 caches, seeded) it compares two forms of the split
attention with one walk over all tiles (``decode_attention_plain``),
under chip_smoke's flash rule (relative Frobenius error, limit 2^-10):

  own max     each split of one tile rounds P against its own score max,
              and the partial states are combined afterwards
  seeded      ``decode_attention_plain(..., splits=9)``: each split starts
              from the max of all scores before it (the kernel's form)

and prints the relative Frobenius error of each against one walk.
"""
from __future__ import annotations

import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops import decode_attention as da  # noqa: E402


def own_max(q, kc, vc, layer, pos):
    """Each 128-column tile a split that rounds P against its own max."""
    B, NH, HD = q.shape
    T = kc.shape[-1]
    nkv = kc.shape[2] // HD
    kl = kc[layer].reshape(B, nkv, HD, T)
    vl = vc[layer].reshape(B, nkv, HD, T)
    qf = q.float().reshape(B, nkv, NH // nkv, HD)
    m0 = torch.full(qf.shape[:-1], float("-inf"))
    parts = [da._walk(qf, kl, vl, [c0], pos, m0, vc.dtype)
             for c0 in range(0, pos + 1, da.TILE_T)]
    mx = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(p[1] * torch.exp2(p[0] - mx) for p in parts)
    acc = sum(p[2] * torch.exp2(p[0] - mx)[..., None] for p in parts)
    return (acc / l[..., None]).reshape(B, NH, HD)


def main():
    g = torch.Generator().manual_seed(0)
    b, nh, nkv, hd, T, pos = 8, 32, 4, 64, 1152, 1023
    q = (torch.randn((b, nh, hd), generator=g)
         * (da.LOG2E / math.sqrt(hd))).to(torch.bfloat16)
    kc, vc = (torch.randn((2, b, nkv * hd, T), generator=g)
              .to(torch.bfloat16) for _ in range(2))
    one = da.decode_attention_plain(q, kc, vc, 1, pos)
    for name, got in (("own max", own_max(q, kc, vc, 1, pos)),
                      ("seeded", da.decode_attention_plain(q, kc, vc, 1,
                                                           pos, 9))):
        fro = ((got - one).norm() / one.norm()).item()
        print(f"{name}: relative Frobenius error against one walk {fro:.3e}"
              f" (limit {2 ** -10:.3e})")


if __name__ == "__main__":
    main()
