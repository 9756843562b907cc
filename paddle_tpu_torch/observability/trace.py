"""Trace attribution primitives (port of
``paddle_tpu/observability/trace.py``).

- ``comm_span(name)``: a context manager around a site's device work. It
  opens ``torch.profiler.record_function(name)``, so the span shows in a
  torch profiler trace of the card beside the kernels launched inside it,
  and tallies ``{name}.calls`` / ``{name}.bytes`` counters (and, with
  ``site=``, ``site.<site>.{calls,bytes,ms}``). Where the JAX package
  opens a ``jax.named_scope`` at trace time, the port's spans run eagerly:
  they count executions, and ``.ms`` is host wall time inside the span.

- counters: a process-global tally the spans and the engine bump.
  ``reset_counters()`` before a run and ``counters()`` after give its
  attribution.

- ``overlap_flags()``: the overlap switches of tensor and pipeline
  parallelism as 0/1, the ``overlap`` entry of ``StepMetrics.summary()``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

from .. import envs

ENV_TELEMETRY = "PADDLE_TPU_TORCH_TELEMETRY"
ENV_TELEMETRY_DIR = "PADDLE_TPU_TORCH_TELEMETRY_DIR"


def telemetry_enabled(explicit: Optional[bool] = None) -> bool:
    """Telemetry switch: an explicit argument wins, else
    ``PADDLE_TPU_TORCH_TELEMETRY``."""
    if explicit is not None:
        return bool(explicit)
    return envs.get(ENV_TELEMETRY)


def telemetry_dir() -> Optional[str]:
    """Step-log directory from ``PADDLE_TPU_TORCH_TELEMETRY_DIR`` (None: no
    file)."""
    return envs.get(ENV_TELEMETRY_DIR)


_counters: Dict[str, float] = {}
_lock = threading.Lock()


def record_counter(name: str, value: float = 1.0) -> None:
    """Add ``value`` to counter ``name`` (creates at 0)."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + float(value)


def set_counter(name: str, value: float) -> None:
    with _lock:
        _counters[name] = float(value)


def counters() -> Dict[str, float]:
    """Snapshot of every counter."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


@contextlib.contextmanager
def comm_span(name: str, nbytes: Optional[int] = None,
              site: Optional[str] = None):
    """Attribute a site: a ``torch.profiler.record_function`` span plus
    ``{name}.calls`` / ``{name}.bytes`` counters.

    ``site=`` is the stable attribution key shared by every instance of
    one site family, tallied as ``site.<site>.{calls,bytes,ms}``; the
    ``.ms`` tally is host wall time inside the span (at the serve steps it
    ends with the device-to-host copy of the step's [B] results, so the
    device work is inside it)."""
    record_counter(name + ".calls", 1)
    if nbytes is not None:
        record_counter(name + ".bytes", int(nbytes))
    if site is not None:
        record_counter(f"site.{site}.calls", 1)
        if nbytes is not None:
            record_counter(f"site.{site}.bytes", int(nbytes))
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if site is not None:
            record_counter(f"site.{site}.ms",
                           (time.perf_counter() - t0) * 1e3)


def overlap_flags() -> Dict[str, int]:
    """The overlap switches as 0/1: ``tp.overlap_on``, the
    collective-matmul rings (``PADDLE_TPU_TORCH_TP_OVERLAP``), and
    ``pp.overlap_on``, the overlapped pipeline schedule
    (``PADDLE_TPU_TORCH_PP_OVERLAP``). A knob that does not parse
    raises."""
    from ..parallel import collective_matmul as _cm
    from ..parallel import pipeline as _pl
    return {"tp.overlap_on": int(_cm.overlap_enabled()),
            "pp.overlap_on": int(_pl.p2p_overlap_enabled())}
