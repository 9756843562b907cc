"""Times rows 24-26 (the grouped matmul's forward, dX and dW) at the
shapes expert parallelism gives them on the card, next to chip_smoke's
table shape (one ERNIE layer's 16,384 rows).

    python3 tools/gmm_chunk_times.py

Each case routes ``ernie_moe_fine``'s tokens (B 8, S 512 over the ranks,
top-4 of 32 experts, random f32 logits from a seed) the way a rank's
buffer holds them: ``ep2_chunk``, the chunk rank 0 sends rank 1 under the
ragged all-to-all at ep 2 (2,048 tokens a rank, 16 local experts,
``a2a_layout``: 10,240 rows); ``dp2_ep2_chunk``, the same at dp 2 x ep 2
(1,024 tokens: 6,144 rows); ``ep4_local``, rank 0's local buffer of the
ragged path at ep 4 (every 4,096 tokens, 8 local experts,
``local_ragged_layout``: 17,408 rows). Both (K, N) of ``e_w1`` and
``e_w2``, bf16: the kernel's device ms (CUDA events over 50 launches),
the plain version's (3), ``torch._grouped_mm``'s (50; chip_smoke's
``_library_gmm``) and the bound, counted as chip_smoke's ``gmm_times``
counts it. Prints one JSON object a case and the card's name and power
limit; writes ``chiprun_out/gmm_chunk_times.json``.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def schedules(dev):
    """{case: (counts [E_local] int32, rows)} of the three buffers."""
    from paddle_tpu_torch.parallel import moe as tmoe
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    tokens, E, k, tile = cs.MOE_B * cs.MOE_S, 32, 4, 128

    def experts(T):
        logits = torch.randn((T, E), generator=g, device=dev)
        return tmoe._top_k(torch.softmax(logits, -1), k)[1].reshape(-1)
    out = {}
    for name, ranks in (("ep2_chunk", 2), ("dp2_ep2_chunk", 4)):
        T, el = tokens // ranks, E // 2
        _, counts, rows = tmoe.a2a_layout(experts(T), 0, 2, el, T, k, tile)
        out[name] = (counts[1].contiguous(), rows)
    _, counts, rows = tmoe.local_ragged_layout(experts(tokens), 0, E // 4,
                                               tokens, k, tile)
    out["ep4_local"] = (counts, rows)
    return out


def main():
    from paddle_tpu_torch import _build
    from paddle_tpu_torch.ops import grouped_matmul as tg
    card = cs._card_line()
    print(card, flush=True)
    _build.build_all(["grouped_matmul"])
    dev = torch.device("cuda", 0)
    res = {"card": card}
    for case, (counts, rows) in schedules(dev).items():
        full = tg.chunk_schedule(counts, rows, 128)
        sched = full[:2]
        offsets = tg.tile_schedule(counts, rows // 128, 128)[4]
        e = counts.shape[0]
        routed = int(counts.sum())
        active = int((counts > 0).sum())
        sched_bytes = 2 * (rows // 128) * 4
        for k, n in cs.MOE_SHAPES:
            lhs, rhs, dout = cs._gmm_operands(dev, torch.bfloat16, rows, e,
                                              k, n, cs.SEED)
            calls = {
                "gmm_fwd": (lambda: tg.gmm_fwd(lhs, rhs, sched),
                            lambda: tg.gmm_fwd_plain(lhs, rhs, sched),
                            ("fwd", lhs, rhs),
                            2 * (routed * k + active * k * n + rows * n)),
                "gmm_dx": (lambda: tg.gmm_dx(dout, rhs, sched),
                           lambda: tg.gmm_dx_plain(dout, rhs, sched),
                           ("dx", dout, rhs),
                           2 * (routed * n + active * k * n + rows * k)),
                "gmm_dw": (lambda: tg.gmm_dw(lhs, dout, sched,
                                             num_experts=e),
                           lambda: tg.gmm_dw_plain(lhs, dout, sched,
                                                   num_experts=e),
                           ("dw", lhs, dout),
                           2 * (routed * (k + n) + e * k * n)),
            }
            for name, (kern, plain, lib, nbytes) in calls.items():
                desc, lib_fn, _ = cs._library_gmm(*lib, offsets, counts)
                r = dict(cs._timed(kern, 50),
                         plain_ms=cs._timed(plain, 3)["ms"],
                         library_ms=cs._timed(lib_fn, 50)["ms"],
                         library=desc, routed_rows=routed, rows=rows,
                         experts=e,
                         **cs._bound(nbytes + sched_bytes,
                                     2 * routed * k * n, cs.BF16_OPS_PER_S))
                key = f"{case}/{name}[K={k},N={n}]"
                res[key] = r
                print(json.dumps({key: r}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gmm_chunk_times.json"),
              "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
