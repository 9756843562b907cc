"""Accuracy of the flash kernels at long sequence lengths (card).

    python3 tools/flash_long_accuracy.py [S ...]      # default 65536 131072
    python3 tools/flash_long_accuracy.py --varlen [--heads H] [L ...]

For each S (one head, D = 128, causal, bf16, seeded) the forward (row 14)
and both backwards (row 16; row 18's dQ) run on the card beside their
plain versions, and all of them are compared with a reference whose
products are summed in f64 from the same rounded operands (the forward:
an f64 softmax of the same inputs; the backward: P and dS rounded where
the kernels round them, then every product in f64). For each output it
prints the relative Frobenius error and the drift along the reference,
sum((got - ref) * ref) / sum(ref * ref): a kernel whose sums lose to
rounding toward zero shows a negative drift that grows with S, where a
summation order only adds noise around 0. Row 18's drift excess over the
plain version is held to chip_smoke's ``VARLEN_DRIFT_EXCESS``; the tool
exits non-zero if it exceeds it. Needs one CUDA device.

With --varlen, the packed varlen kernels: for each L (default 65536) one
L-token segment (H heads in one call, default 1, and with H > 1 each
head's backward alone too; D = 128, causal, bf16, seeded), then
chip_smoke's long pack
(16 x 4,096 tokens, 32 heads): the forward (row 20), the fused backward
(row 21) and the split pair (row 23's dQ, row 22's dK and dV) beside
their plain versions, against references summed in f64 from the same
rounded operands (chip_smoke's ``varlen_bwd_f64``; the forward an f64
softmax, chip_smoke's ``varlen_fwd_f64``). The drift excess over the
plain version of every output of rows 20-23 is held to chip_smoke's
``VARLEN_DRIFT_EXCESS``; the tool exits non-zero if one exceeds it.
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
    good = True
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
        # row 18, in a tree that has it (a copy of an older commit may not),
        # its drift excess over the plain version held to chip_smoke's
        # VARLEN_DRIFT_EXCESS
        if hasattr(fa, "flash_bwd_dq"):
            dq18 = fa.flash_bwd_dq(*args)
            report("dq row 18 vs f64", dq18, ref[0])
            good &= held("dq row 18",
                         drift(dq18, ref[0]) - drift(plain[0], ref[0]))
            del dq18
        del kern, plain, ref
        torch.cuda.empty_cache()
    sys.exit(0 if good else 1)


def drift(got, ref):
    g, r = got.double(), ref.double()
    return ((g - r) * r).sum().item() / (r * r).sum().item()


def held(name, excess):
    """Prints a drift excess over the plain version against chip_smoke's
    VARLEN_DRIFT_EXCESS; True when within it."""
    import chip_smoke as cs
    ok = abs(excess) <= cs.VARLEN_DRIFT_EXCESS
    print(f"  {name} drift excess over plain {excess:+.3e} (limit "
          f"{cs.VARLEN_DRIFT_EXCESS:g}): {'ok' if ok else 'OVER'}",
          flush=True)
    return ok


def main_varlen(lengths, heads):
    if not torch.cuda.is_available():
        sys.exit("flash_long_accuracy: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_varlen as fv
    dev, d = torch.device("cuda"), 128
    scale = d ** -0.5
    cases = [(f"one segment of {n} tokens, {heads} head(s)", [n], heads)
             for n in lengths]
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
        o64 = cs.varlen_fwd_f64(qh, kh, vh, lens, scale)
        report("o row 20 vs f64", o, o64)
        report("o plain vs f64", o_p, o64)
        good &= held("o row 20", drift(o, o64) - drift(o_p, o64))
        del o, o64
        delta = (doh.float() * o_p.float()).sum(-1).contiguous()
        args = (qh, kh, vh, doh, lse, delta, cu, cu, True, scale)
        ref = cs.varlen_bwd_f64(qh, kh, vh, doh, lse, delta, lens, scale)
        plain = fv.varlen_bwd_plain(*args)
        fused = fv.varlen_bwd(*args)
        split = (fv.varlen_bwd_dq(*args), *fv.varlen_bwd_dkv(*args))
        torch.cuda.synchronize()
        for i, n in enumerate(("dq", "dk", "dv")):
            row = "row 23" if n == "dq" else "row 22"
            report(f"{n} plain vs f64", plain[i], ref[i])
            report(f"{n} row 21 vs f64", fused[i], ref[i])
            report(f"{n} {row} vs f64", split[i], ref[i])
            base = drift(plain[i], ref[i])
            good &= held(f"{n} row 21", drift(fused[i], ref[i]) - base)
            good &= held(f"{n} {row}", drift(split[i], ref[i]) - base)
        for i in range(h if h > 1 and len(lens) == 1 else 0):
            # head i alone: the kernels' bits do not depend on the batch of
            # heads; the plain version's batched f32 products may
            one = tuple(x[i:i + 1].contiguous() for x in args[:6]) + args[6:]
            p1 = fv.varlen_bwd_plain(*one)
            s1 = (fv.varlen_bwd_dq(*one), *fv.varlen_bwd_dkv(*one))
            for j, n in enumerate(("dq", "dk", "dv")):
                r1 = ref[j][i:i + 1]
                print(f"  head {i} alone, {n}: split kernel "
                      f"{'equal to' if torch.equal(s1[j], split[j][i:i + 1]) else 'NOT'}"
                      f" its bits in the batch, plain "
                      f"{'equal to' if torch.equal(p1[j], plain[j][i:i + 1]) else 'NOT'}"
                      f" its; drift kernel {drift(s1[j], r1):+.3e}, plain "
                      f"alone {drift(p1[j], r1):+.3e}, plain in the batch "
                      f"{drift(plain[j][i:i + 1], r1):+.3e}", flush=True)
            del p1, s1
        del q, k, v, do, qh, kh, vh, doh, ref, plain, fused, split, args
        torch.cuda.empty_cache()
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--varlen"]:
        args = sys.argv[2:]
        h = 1
        if args[:1] == ["--heads"]:
            h, args = int(args[1]), args[2:]
        main_varlen([int(a) for a in args] or [65536], h)
    else:
        main([int(a) for a in sys.argv[1:]] or [65536, 131072])
