"""Times the checkpoint snapshot's device-to-host copy on one card.

    python3 tools/snapshot_copy.py [GB]

``save_state_dict`` blocks the training loop for one thing: the owned host
copy of every leaf, made with a blocking ``tensor.to("cpu")`` into
pageable memory. This script times that copy for GB gigabytes (default
6.67, chip_smoke's resume state: llama_7b's width at 2 layers, bf16
params and f32 moments) in two leaves, three times, beside the same copy
into page-locked memory (``torch.empty(..., pin_memory=True).copy_``),
whose first call also pays for locking the pages and whose later calls
reuse them from PyTorch's caching host allocator. Prints one JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import torch


def main():
    gb = float(sys.argv[1]) if len(sys.argv) > 1 else 6.67
    if not torch.cuda.is_available():
        sys.exit("snapshot_copy: needs a CUDA device")
    dev = torch.device("cuda", 0)
    xs = [torch.ones(int(gb * 1e9) // 8, device=dev) for _ in range(2)]
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [x.to("cpu") for x in xs]
        pageable = time.perf_counter() - t0
        del hs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
              for x in xs]
        pinned = time.perf_counter() - t0
        assert all(bool(h.eq(1).all()) for h in hs)
        del hs
        runs.append({"pageable_s": pageable, "pinned_s": pinned,
                     "pageable_gb_s": gb / pageable, "pinned_gb_s": gb / pinned})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "gb": gb,
                      "runs": runs}))


if __name__ == "__main__":
    main()
