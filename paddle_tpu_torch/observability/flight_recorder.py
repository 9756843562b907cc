"""Failure flight recorder: a bounded ring of recent iteration records
(port of ``paddle_tpu/observability/flight_recorder.py``).

Post-mortems should not depend on having had tracing enabled. The
recorder keeps the last N iteration/step records (queue depth, batch
occupancy, pool utilization, per-phase ms, compile events — whatever
dict the caller hands it) in a fixed-size ring, costing one deque append
per step, and dumps the ring as JSON to ``PADDLE_TPU_TORCH_TELEMETRY_DIR``
when something goes wrong:

- **exception** — the engine's driving loop re-raises after
  ``dump("exception")``, so the crash report carries the last N steps;
- **eviction storm** — eviction rate over a sliding window crosses
  ``STORM_RATE`` (a thrashing pool: requests recompute more than they
  decode);
- **step-time spike** — a step lands ``spike_mad`` robust sigmas from
  the window median (MAD × 1.4826 ≈ σ under normality), the classic
  sign of a recompile, host stall, or preemption hiccup.

Each trigger dumps at most once per recorder (a storm would otherwise
write a file per iteration). Everything here is host-side Python over
values already on the host — no device syncs.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional

from .. import envs
from .exporters import _jsonable
from .trace import telemetry_dir

__all__ = ["FlightRecorder", "flight_recorder_enabled", "STORM_WINDOW",
           "STORM_RATE", "MIN_SPIKE_SAMPLES"]

ENV_FLIGHT_RECORDER = "PADDLE_TPU_TORCH_FLIGHT_RECORDER"
ENV_FLIGHT_RECORDER_SIZE = "PADDLE_TPU_TORCH_FLIGHT_RECORDER_SIZE"
ENV_SPIKE_MAD = "PADDLE_TPU_TORCH_SPIKE_MAD"

# Eviction-storm policy: more than STORM_RATE evictions per iteration
# averaged over the last STORM_WINDOW iterations is thrashing.
STORM_WINDOW = 32
STORM_RATE = 0.5
# The MAD detector stays quiet until it has seen this many step times
# (median/MAD over fewer samples flags ordinary warmup jitter).
MIN_SPIKE_SAMPLES = 16
_MAD_SIGMA = 1.4826  # MAD -> sigma under normality
# Median/MAD are refit every this many steps, not every step: the window
# statistics drift slowly, and the two sorts per fit would otherwise be
# the recorder's entire per-iteration cost. A suspected spike always
# refits fresh before firing, so stale stats never cause a false dump.
_SPIKE_REFIT_EVERY = 16


def flight_recorder_enabled(explicit: Optional[bool] = None) -> bool:
    """Recorder switch: explicit argument wins, else the env knob."""
    if explicit is not None:
        return bool(explicit)
    return envs.get(ENV_FLIGHT_RECORDER)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class FlightRecorder:
    """Fixed-size ring of iteration records + anomaly triggers.

    >>> rec = FlightRecorder(source="engine")
    >>> rec.record({"iteration": i, "queue_depth": q, ...})
    >>> rec.note_eviction(iteration=i)           # on each preemption
    >>> rec.check_step_time(step_time_s)          # MAD spike detector
    >>> rec.dump("exception")                     # on crash, then re-raise
    """

    def __init__(self, source: str = "engine", size: Optional[int] = None,
                 spike_mad: Optional[float] = None,
                 out_dir: Optional[str] = None):
        self.source = source
        self.size = int(size if size is not None
                        else envs.get(ENV_FLIGHT_RECORDER_SIZE))
        self.spike_mad = float(spike_mad if spike_mad is not None
                               else envs.get(ENV_SPIKE_MAD))
        self.out_dir = out_dir
        self.ring: collections.deque = collections.deque(maxlen=self.size)
        self._step_times: collections.deque = collections.deque(
            maxlen=self.size)
        self._evictions: collections.deque = collections.deque()
        self._spike_med: Optional[float] = None
        self._spike_sigma = 0.0
        self._since_refit = 0
        self._iteration = 0
        self.dumped: List[str] = []          # paths written this run
        self._fired: set = set()             # one dump per trigger kind
        self.anomalies: List[Dict[str, Any]] = []

    # -- recording ------------------------------------------------------------

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one iteration/step record to the ring (O(1), no copy of
        older entries; the deque drops the oldest at capacity)."""
        self._iteration = int(rec.get("iteration", self._iteration + 1))
        self.ring.append(rec)

    def record_compile(self, kind: str, compile_s: float) -> None:
        self.ring.append({"iteration": self._iteration, "event": "compile",
                          "kind": kind, "compile_s": compile_s})

    # -- triggers -------------------------------------------------------------

    def note_eviction(self, iteration: int) -> Optional[str]:
        """Track one preemption; dumps when the sliding-window eviction
        rate crosses the storm threshold. Returns the dump path if fired."""
        self._evictions.append(iteration)
        floor = iteration - STORM_WINDOW
        while self._evictions and self._evictions[0] <= floor:
            self._evictions.popleft()
        rate = len(self._evictions) / STORM_WINDOW
        if rate > STORM_RATE:
            self.anomalies.append({"kind": "eviction_storm",
                                   "iteration": iteration,
                                   "rate_per_iter": rate})
            return self.dump("eviction_storm")
        return None

    def _refit_spike(self) -> None:
        """Recompute the cached window median/MAD (excluding the sample
        just appended, so a spike never masks itself)."""
        xs = list(self._step_times)
        xs.pop()
        med = _median(xs)
        mad = _median([abs(x - med) for x in xs])
        self._spike_med = med
        self._spike_sigma = _MAD_SIGMA * mad
        self._since_refit = 0

    def _is_spike(self, v: float) -> bool:
        med, sigma = self._spike_med, self._spike_sigma
        if sigma <= 0:
            # degenerate window (identical times, e.g. mocked clocks):
            # fall back to a pure multiple-of-median test
            return v > med * self.spike_mad
        return abs(v - med) > self.spike_mad * sigma

    def check_step_time(self, step_time_s: float) -> Optional[str]:
        """MAD-based spike detector over the recent step-time window.
        Returns the dump path when a spike fires, else None."""
        prior = len(self._step_times)
        self._step_times.append(float(step_time_s))
        if prior < MIN_SPIKE_SAMPLES:
            return None
        self._since_refit += 1
        if self._spike_med is None or self._since_refit >= _SPIKE_REFIT_EVERY:
            self._refit_spike()
        if not self._is_spike(step_time_s):
            return None
        if self._since_refit:
            # suspected against stale stats: refit fresh and retest before
            # committing to a dump
            self._refit_spike()
            if not self._is_spike(step_time_s):
                return None
        self.anomalies.append({
            "kind": "step_time_spike", "iteration": self._iteration,
            "step_time_s": float(step_time_s), "median_s": self._spike_med,
            "mad_s": self._spike_sigma / _MAD_SIGMA,
            "threshold_mads": self.spike_mad,
        })
        return self.dump("step_time_spike")

    # -- dumping --------------------------------------------------------------

    def dump(self, reason: str, out_dir: Optional[str] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring to ``<dir>/flightrec-<source>-<reason>-<pid>.json``.

        Directory resolution: explicit arg, then the recorder's ``out_dir``,
        then ``PADDLE_TPU_TORCH_TELEMETRY_DIR``; with none set the dump is
        skipped (returns None) — the ring stays inspectable in-process.
        Each ``reason`` fires at most once unless ``force``.
        """
        if reason in self._fired and not force:
            return None
        d = out_dir or self.out_dir or telemetry_dir()
        if d is None:
            return None
        self._fired.add(reason)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flightrec-{self.source}-{reason}-{os.getpid()}.json")
        payload = {
            "source": self.source,
            "reason": reason,
            "wall_time": time.time(),
            "iteration": self._iteration,
            "ring_size": self.size,
            "n_records": len(self.ring),
            "anomalies": self.anomalies,
            "records": list(self.ring),
        }
        with open(path, "w") as f:
            json.dump(payload, f, default=_jsonable)
        self.dumped.append(path)
        return path


def load_dump(path: str) -> Dict[str, Any]:
    """Read a flight-recorder dump back (post-mortem tooling/tests)."""
    with open(path) as f:
        return json.load(f)
