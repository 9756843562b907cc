"""Probes the card's machine for what the checkpoint phases depend on.

    python3 tools/machine_probe.py

Prints the Python, torch and CUDA versions; the free disk under the
checkout, the temp directory and /dev/shm; ``df -h`` and ``free -g``;
then, for one 2 GB bf16 tensor, the device-to-host copy rate into
pageable memory (twice), the rate of writing it to a file under
``tempfile.mkdtemp()``, of CRC32 over it, of reading the file back with
``np.fromfile`` (a warm read: the file was just written) and of the
host-to-device copy; last the card's name and power limit.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

GB = 2.0


def rate(what, t0):
    print(what, "GB/s", GB / (time.perf_counter() - t0))


def main():
    print(sys.version, torch.__version__, torch.version.cuda)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for p in (root, tempfile.gettempdir(), "/dev/shm"):
        try:
            u = shutil.disk_usage(p)
            print(p, "total", u.total / 1e9, "free", u.free / 1e9)
        except OSError as e:
            print(p, e)
    for cmd in (["df", "-h"], ["free", "-g"]):
        print(subprocess.run(cmd, capture_output=True, text=True).stdout)
    print(os.cpu_count(), os.environ.get("TMPDIR"), os.environ.get("HOME"))
    x = torch.empty(int(GB * 1e9) // 2, dtype=torch.bfloat16,
                    device="cuda").fill_(1)
    for what in ("d2h pageable", "d2h pageable again"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = x.to("cpu")
        rate(what, t0)
    raw = memoryview(h.view(torch.int16).numpy()).cast("B")
    d = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        with open(os.path.join(d, "a.bin"), "wb") as f:
            f.write(raw)
        rate("write", t0)
        t0 = time.perf_counter()
        zlib.crc32(raw)
        rate("crc", t0)
        t0 = time.perf_counter()
        a = np.fromfile(os.path.join(d, "a.bin"), dtype=np.int16)
        rate("read", t0)
        t0 = time.perf_counter()
        x.copy_(torch.from_numpy(a).view(torch.bfloat16))
        torch.cuda.synchronize()
        rate("h2d", t0)
    finally:
        shutil.rmtree(d)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout)


if __name__ == "__main__":
    main()
