"""Telemetry exporters: JSONL step logs and Chrome trace files (port of
``paddle_tpu/observability/exporters.py``; the TensorBoard writer and the
rank logger are not ported).

Exporters share one duck type, ``write(record: dict)`` + ``close()``, so
``StepMetrics.attach`` composes them. Writes are buffered (flushed every
``flush_every`` records and on close): an attached exporter costs an
in-memory append on the hot path, not a syscall.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _jsonable(obj):
    """json.dumps default= hook: numpy scalars and arrays, 0-d tensors ->
    python numbers (a card tensor is copied to the host: the caller's
    call)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.dim() == 0 else obj.tolist()
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return str(obj)


class JsonlWriter:
    """Append-only JSONL step log (one record per line)."""

    def __init__(self, path: str, flush_every: int = 64):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        self._flush_every = max(1, int(flush_every))
        self._pending = 0

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=_jsonable) + "\n")
        self._pending += 1
        if self._pending >= self._flush_every:
            self._f.flush()
            self._pending = 0

    def flush(self) -> None:
        self._f.flush()
        self._pending = 0

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except Exception:
            pass


def write_chrome_trace(path: str, events) -> str:
    """Write a Chrome trace-event JSON file (``{"traceEvents": [...]}``);
    ``events`` is an iterable of trace-event dicts (µs timebase). Opens in
    Perfetto / chrome://tracing."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": list(events)}, f, default=_jsonable)
    return path


def load_jsonl(path: str):
    """Read a JSONL step log back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def process_rank() -> int:
    """This process's rank: ``PADDLE_TRAINER_ID`` when the launcher set
    it, else ``torch.distributed``'s rank once a process group is up, else
    0."""
    env = os.environ.get("PADDLE_TRAINER_ID")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
