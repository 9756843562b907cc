"""Accuracy of the dense flash kernels at long sequence lengths (card).

    python3 tools/flash_long_accuracy.py [S ...]      # default 65536 131072

For each S (one head, D = 128, causal, bf16, seeded) the forward (row 14)
and both backwards (row 16; row 18's dQ) run on the card beside their
plain versions, and all of them are compared with a reference whose
products are summed in f64 from the same rounded operands (the forward:
an f64 softmax of the same inputs; the backward: P and dS rounded where
the kernels round them, then every product in f64). For each output it
prints the relative Frobenius error and the drift along the reference,
sum((got - ref) * ref) / sum(ref * ref): a kernel whose sums lose to
rounding toward zero shows a negative drift that grows with S, where a
summation order only adds noise around 0. Needs one CUDA device.
"""
from __future__ import annotations

import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def bwd_f64(q, k, v, do, lse, delta, scale, rows=1024):
    """The plain backward's rounding points, its products summed in f64."""
    dev, dt = q.device, q.dtype
    sq = q.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float64, device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=dev)
    dv = torch.zeros_like(dk)
    lse2 = lse.float() * fa.LOG2E
    for h in range(q.shape[0]):
        kf, vf = k[h].float(), v[h].float()
        for r0 in range(0, sq, rows):
            r1 = min(r0 + rows, sq)
            qf, dof = q[h, r0:r1].float(), do[h, r0:r1].float()
            s = qf @ kf[:r1].T
            dead = (torch.arange(r1, device=dev)[None]
                    > torch.arange(r0, r1, device=dev)[:, None])
            p = torch.exp2(s.masked_fill(dead, -1e30) - lse2[h, r0:r1, None])
            dp = dof @ vf[:r1].T
            ds = (p * (dp - delta[h, r0:r1, None])).to(dt).double()
            dv[h, :r1] += p.to(dt).double().T @ dof.double()
            dk[h, :r1] += ds.T @ qf.double()
            dq[h, r0:r1] = (ds @ kf[:r1].double()) * scale
    return dq, dk * fa.LN2, dv


def fwd_f64(q, k, v, rows=2048):
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.float64, device=dev)
    for h in range(q.shape[0]):
        for r0 in range(0, q.shape[1], rows):
            r1 = min(r0 + rows, q.shape[1])
            s = q[h, r0:r1].double() @ k[h, :r1].double().T
            dead = (torch.arange(r1, device=dev)[None]
                    > torch.arange(r0, r1, device=dev)[:, None])
            p = torch.softmax(s.masked_fill(dead, -1e300) * math.log(2), -1)
            o[h, r0:r1] = p @ v[h, :r1].double()
    return o


def report(name, got, ref):
    g, r = got.double(), ref.double()
    d = g - r
    fro = (d.norm() / r.norm()).item()
    drift = ((d * r).sum() / (r * r).sum()).item()
    print(f"  {name}: rel frob {fro:.3e}  drift along ref {drift:+.3e}",
          flush=True)


def main(lengths):
    if not torch.cuda.is_available():
        sys.exit("flash_long_accuracy: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, d = torch.device("cuda"), 128
    for s in lengths:
        g = torch.Generator(device=dev).manual_seed(s)
        qs = (torch.randn((1, s, d), generator=g, device=dev)
              * (fa.LOG2E / d ** 0.5)).bfloat16()
        k, v, do = (torch.randn((1, s, d), generator=g, device=dev)
                    .bfloat16() for _ in range(3))
        o, _ = fa.flash_fwd(qs, k, v, True)
        o_p, lse = fa.flash_fwd_plain(qs, k, v, True)
        print(f"S={s}", flush=True)
        o64 = fwd_f64(qs, k, v)
        report("o kernel vs f64", o, o64)
        report("o plain vs f64", o_p, o64)
        del o64
        delta = (do.float() * o_p.float()).sum(-1)
        args = (qs, k, v, do, lse, delta, True, d ** -0.5)
        kern = fa.flash_bwd(*args)
        plain = fa.flash_bwd_plain(*args)
        ref = bwd_f64(qs, k, v, do, lse, delta, d ** -0.5)
        for i, n in enumerate(("dq", "dk", "dv")):
            report(f"{n} row 16 vs f64", kern[i], ref[i])
            report(f"{n} plain vs f64", plain[i], ref[i])
            report(f"{n} row 16 vs plain", kern[i], plain[i])
        # row 18, in a tree that has it (a copy of an older commit may not)
        if hasattr(fa, "flash_bwd_dq"):
            report("dq row 18 vs f64", fa.flash_bwd_dq(*args), ref[0])
        del kern, plain, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [65536, 131072])
