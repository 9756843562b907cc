"""Accuracy of the flash kernels at long sequence lengths (card).

    python3 tools/flash_long_accuracy.py [S ...]      # default 65536 131072
    python3 tools/flash_long_accuracy.py --varlen [L ...]   # default 65536

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

With --varlen, the packed varlen kernels: for each L one L-token segment
(one head, D = 128, causal, bf16, seeded), then chip_smoke's long pack
(16 x 4,096 tokens, 32 heads): the forward (row 20), the fused backward
(row 21) and the split pair (row 23's dQ, row 22's dK and dV) beside
their plain versions, against references summed in f64 from the same
rounded operands (chip_smoke's ``varlen_bwd_f64``; the forward an f64
softmax). Each split output's drift excess over its plain version is
held to chip_smoke's ``VARLEN_DRIFT_EXCESS``; the tool exits non-zero if
one exceeds it.
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


def varlen_fwd_f64(q, k, v, lens, scale, rows=2048):
    """A causal self-attention pack's o from an f64 softmax: q, k, v
    [H, T, D] -> o f64."""
    dev = q.device
    o = torch.zeros(q.shape, dtype=torch.float64, device=dev)
    a = 0
    for n in lens:
        for r0 in range(0, n, rows):
            r1 = min(r0 + rows, n)
            s = (q[:, a + r0:a + r1].double()
                 @ k[:, a:a + r1].double().transpose(1, 2)) * scale
            dead = (torch.arange(r1, device=dev)[None]
                    > torch.arange(r0, r1, device=dev)[:, None])
            p = torch.softmax(s.masked_fill(dead, -math.inf), -1)
            o[:, a + r0:a + r1] = p @ v[:, a:a + r1].double()
        a += n
    return o


def drift(got, ref):
    g, r = got.double(), ref.double()
    return ((g - r) * r).sum().item() / (r * r).sum().item()


def main_varlen(lengths):
    if not torch.cuda.is_available():
        sys.exit("flash_long_accuracy: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_varlen as fv
    dev, d = torch.device("cuda"), 128
    scale = d ** -0.5
    cases = [(f"one segment of {n} tokens, 1 head", [n], 1) for n in lengths]
    cases.append((f"long pack 16 x 4096, {cs.VARLEN_H} heads", cs.VARLEN_LONG,
                  cs.VARLEN_H))
    good = True
    for name, lens, h in cases:
        print(f"{name} (D={d}, causal, bf16)", flush=True)
        q, k, v, do = cs._varlen_inputs(dev, torch.bfloat16, lens, None, h, d,
                                        cs.SEED + 70)
        qh, kh, vh, doh = (x.transpose(0, 1) for x in (q, k, v, do))
        cu = cs._cu_dev(lens, dev)
        o, _ = fv.varlen_fwd(qh, kh, vh, cu, cu, True, scale)
        o_p, lse = fv.varlen_fwd_plain(qh, kh, vh, cu, cu, True, scale)
        o64 = varlen_fwd_f64(qh, kh, vh, lens, scale)
        report("o row 20 vs f64", o, o64)
        report("o plain vs f64", o_p, o64)
        del o, o64
        delta = (doh.float() * o_p.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        ref = cs.varlen_bwd_f64(qh, kh, vh, doh, lse, delta, lens, scale)
        plain = fv.varlen_bwd_plain(*args)
        fused = fv.varlen_bwd(*args)
        split = (fv.varlen_bwd_dq(*args), *fv.varlen_bwd_dkv(*args))
        torch.cuda.synchronize()
        for i, n in enumerate(("dq", "dk", "dv")):
            report(f"{n} plain vs f64", plain[i], ref[i])
            report(f"{n} row 21 vs f64", fused[i], ref[i])
            row = "row 23" if n == "dq" else "row 22"
            report(f"{n} {row} vs f64", split[i], ref[i])
            excess = drift(split[i], ref[i]) - drift(plain[i], ref[i])
            ok = abs(excess) <= cs.VARLEN_DRIFT_EXCESS
            good &= ok
            print(f"  {n} {row} drift excess over plain {excess:+.3e} "
                  f"(row 21 {drift(fused[i], ref[i]) - drift(plain[i], ref[i]):+.3e}); "
                  f"limit {cs.VARLEN_DRIFT_EXCESS:g}: {'ok' if ok else 'OVER'}",
                  flush=True)
        del q, k, v, do, qh, kh, vh, doh, ref, plain, fused, split, args
        torch.cuda.empty_cache()
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--varlen"]:
        main_varlen([int(a) for a in sys.argv[2:]] or [65536])
    else:
        main([int(a) for a in sys.argv[1:]] or [65536, 131072])
