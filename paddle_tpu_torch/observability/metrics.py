"""Step-level telemetry: wall step time, compile time, tokens/sec, MFU
(port of ``paddle_tpu/observability/metrics.py``).

Nothing here synchronizes the device. Step wall time is the host-side
interval between consecutive ``step()`` calls (or the caller's own
measure); memory stats come from the CUDA caching allocator's host-side
counters (``torch.cuda.memory_allocated`` / ``max_memory_allocated``);
FLOPs per step are the caller's. MFU is FLOPs-per-step over (step_time x
peak FLOPs of the devices).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import torch

from .. import envs
from . import trace as _trace
from .histogram import LogHistogram

ENV_PEAK_FLOPS = "PADDLE_TPU_TORCH_PEAK_FLOPS"

# Per-device peak FLOP/s by device-name substring (dense bf16 peaks, the
# denominators MFU papers use), matched case-insensitively on
# torch.cuda.get_device_name(); FIRST match wins. 'h100 80gb hbm3' is the
# H100 SXM's name, with its dense bf16 tensor-core peak; the PCIe and NVL
# cards have other peaks and fall through to the unknown-device warning.
# The 'cpu' entry is a nominal 100 GFLOP/s so CPU runs report a finite,
# clearly-labeled estimate; override with PADDLE_TPU_TORCH_PEAK_FLOPS.
PEAK_FLOPS_TABLE = (
    ("h100 80gb hbm3", 989e12),
    ("cpu", 100e9),
)


# device_kinds already warned about this process: an unknown platform must
# not fall back SILENTLY (roofline/MFU fractions would be quietly wrong or
# quietly absent), but it must also not spam one warning per StepMetrics
_PEAK_WARNED: set = set()


def peak_flops_info(device=None):
    """(per-device peak FLOP/s, source) — source is ``"env"`` (the
    PADDLE_TPU_TORCH_PEAK_FLOPS override), ``"table:<key>"`` (the row that
    matched the device's name), or ``"unknown:<kind>"`` with a
    once-per-run warning NAMING the device so an MFU gap is never a silent
    None. ``device`` is a torch device (default: the card when there is
    one, else the CPU)."""
    env = envs.get(ENV_PEAK_FLOPS)
    if env is not None:
        return env, "env"
    kind = device_name(device).lower()
    for key, flops in PEAK_FLOPS_TABLE:
        if key in kind:
            return flops, f"table:{key}"
    if kind not in _PEAK_WARNED:
        _PEAK_WARNED.add(kind)
        import warnings
        warnings.warn(
            f"no peak-FLOPs table entry for device_kind {kind!r}: MFU and "
            f"roofline fractions will be unavailable for this platform — "
            f"set PADDLE_TPU_TORCH_PEAK_FLOPS or extend "
            f"observability.metrics.PEAK_FLOPS_TABLE", stacklevel=2)
    return None, f"unknown:{kind or '?'}"


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device (default: the
    current card when there is one), ``"cpu"`` otherwise."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _default_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak FLOP/s for one device, from ``PADDLE_TPU_TORCH_PEAK_FLOPS``
    (wins) or the device-name table; None (with a once-per-run warning via
    :func:`peak_flops_info`) when the kind is unknown."""
    return peak_flops_info(device)[0]


class StepMetrics:
    """Per-step telemetry collector.

    Typical wiring::

        m = StepMetrics(n_devices=1)
        m.attach(JsonlWriter(path))
        m.record_compile(compile_s=..., trace_s=..., flops=...)   # per compile
        m.step(tokens=B * S)                                      # per step

    ``step()`` builds one record dict, appends it to a bounded window, and
    hands it to every attached exporter. ``summary()`` aggregates the window
    and folds in the span counters (:mod:`.trace`).
    """

    def __init__(self, name: str = "train", tokens_per_step: Optional[int] = None,
                 n_devices: Optional[int] = None,
                 peak_flops: Optional[float] = None, window: int = 512):
        self.name = name
        self.tokens_per_step = tokens_per_step
        self.n_devices = (n_devices if n_devices is not None
                          else _default_devices())
        if peak_flops is not None:
            per_dev, self.mfu_peak_source = peak_flops, "arg"
        else:
            per_dev, self.mfu_peak_source = peak_flops_info()
        self.peak_flops_total = (per_dev * self.n_devices
                                 if per_dev is not None else None)
        self.flops_per_step: Optional[float] = None
        self.compile_time_s = 0.0
        self.trace_time_s = 0.0
        self.compiles = 0
        self.recompiles = 0  # compiles beyond the first
        self.steps = 0
        self.records: collections.deque = collections.deque(maxlen=window)
        # full-run step-time distribution at fixed memory (the bounded
        # records window only covers the last `window` steps); seconds,
        # 10 µs .. 10 ks span
        self.step_time_hist = LogHistogram(lo=1e-5, hi=1e4)
        self._last_t: Optional[float] = None
        self._exporters: List = []
        self._mem_fams = None  # (in_use, peak) gauge families, per device

    def register_into(self, registry) -> None:
        """Expose this collector through a :class:`MetricsRegistry`: the
        full-run step-time histogram (by reference), compile accounting
        gauges, and per-device memory gauge families keyed ``device=``
        (refreshed on every :meth:`device_memory` poll, i.e. each step)."""
        registry.summary("step_time_seconds", hist=self.step_time_hist,
                         help="training step wall time (steady-state "
                              "dispatch interval)")
        registry.gauge("steps", fn=lambda: self.steps,
                       help="steps recorded this run")
        registry.gauge("compiles", fn=lambda: self.compiles,
                       help="program (re)compilations observed")
        registry.gauge("recompiles", fn=lambda: self.recompiles,
                       help="compilations beyond the first")
        registry.gauge("compile_time_seconds",
                       fn=lambda: self.compile_time_s,
                       help="cumulative wall time spent compiling")
        self._mem_fams = (
            registry.family("device_mem_bytes_in_use", "gauge",
                            labelnames=("device",),
                            help="live allocated bytes per local card"),
            registry.family("device_mem_peak_bytes_in_use", "gauge",
                            labelnames=("device",),
                            help="peak allocated bytes per local card"))

    # -- wiring -------------------------------------------------------------

    def attach(self, exporter) -> "StepMetrics":
        """Attach an exporter with a ``write(record: dict)`` method."""
        self._exporters.append(exporter)
        return self

    def close(self) -> None:
        for e in self._exporters:
            try:
                e.close()
            except Exception:
                pass

    # -- recording ----------------------------------------------------------

    def record_compile(self, compile_s: float = 0.0, trace_s: float = 0.0,
                       flops: Optional[float] = None) -> None:
        """One (re)compilation: wall compile/trace seconds and, when known,
        the program's cost-analysis FLOPs per executed step."""
        self.compiles += 1
        if self.compiles > 1:
            self.recompiles += 1
        self.compile_time_s += float(compile_s)
        self.trace_time_s += float(trace_s)
        if flops:
            self.flops_per_step = float(flops)
        # a compile step's wall time is compile, not execution: restart the
        # steady-state interval clock
        self._last_t = None

    def device_memory(self) -> Dict:
        """Host-side caching-allocator stats over every local card (no
        sync; {} without CUDA): ``mem_bytes_in_use`` is the sum of
        ``torch.cuda.memory_allocated`` across cards,
        ``mem_peak_bytes_in_use`` the max of ``max_memory_allocated``, and
        ``mem_per_device`` carries each card's pair. When registered into
        a MetricsRegistry the per-card values also refresh the
        ``device=``-labeled gauge families."""
        per_dev = []
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for i in range(n):
            per_dev.append({"device": i,
                            "bytes_in_use": torch.cuda.memory_allocated(i),
                            "peak_bytes_in_use":
                                torch.cuda.max_memory_allocated(i)})
        if not per_dev:
            return {}
        if self._mem_fams is not None:
            fam_use, fam_peak = self._mem_fams
            for e in per_dev:
                if e["bytes_in_use"] is not None:
                    fam_use.labels(device=str(e["device"])).set(
                        e["bytes_in_use"])
                if e["peak_bytes_in_use"] is not None:
                    fam_peak.labels(device=str(e["device"])).set(
                        e["peak_bytes_in_use"])
        in_use = [e["bytes_in_use"] for e in per_dev
                  if e["bytes_in_use"] is not None]
        peaks = [e["peak_bytes_in_use"] for e in per_dev
                 if e["peak_bytes_in_use"] is not None]
        return {"mem_bytes_in_use": sum(in_use) if in_use else None,
                "mem_peak_bytes_in_use": max(peaks) if peaks else None,
                "mem_per_device": per_dev}

    def mfu(self, step_time_s: Optional[float]) -> Optional[float]:
        if (not step_time_s or step_time_s <= 0 or not self.flops_per_step
                or not self.peak_flops_total):
            return None
        return self.flops_per_step / (step_time_s * self.peak_flops_total)

    def step(self, step_time_s: Optional[float] = None,
             tokens: Optional[int] = None, **extra) -> Dict:
        """Record one training step. With no explicit ``step_time_s`` the
        steady-state interval since the previous ``step()`` call is used
        (None on the first step after a (re)compile — no fake numbers)."""
        now = time.perf_counter()
        if step_time_s is None and self._last_t is not None:
            step_time_s = now - self._last_t
        self._last_t = now
        self.steps += 1
        if step_time_s is not None:
            self.step_time_hist.record(step_time_s)
        tokens = tokens if tokens is not None else self.tokens_per_step
        rec: Dict = {
            "name": self.name,
            "step": self.steps,
            "step_time_ms": (step_time_s * 1e3
                             if step_time_s is not None else None),
            "tokens": tokens,
            "tokens_per_sec": (tokens / step_time_s
                               if tokens and step_time_s else None),
            "mfu": self.mfu(step_time_s),
            # provenance of the MFU denominator, so a reader of the JSONL
            # can tell a table-backed fraction from an env override or an
            # unknown-platform None at a glance
            "mfu_peak_source": self.mfu_peak_source,
        }
        rec.update(self.device_memory())
        rec.update(extra)
        self.records.append(rec)
        for e in self._exporters:
            e.write(rec)
        return rec

    # -- aggregation --------------------------------------------------------

    def summary(self) -> Dict:
        """Aggregate view: timing stats over the window, compile accounting,
        MFU at the best step time, and the span counters."""
        times = [r["step_time_ms"] for r in self.records
                 if r.get("step_time_ms")]
        best = min(times) if times else None
        mean = sum(times) / len(times) if times else None
        toks = [r["tokens_per_sec"] for r in self.records
                if r.get("tokens_per_sec")]
        out: Dict = {
            "name": self.name,
            "steps": self.steps,
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "compile_time_s": self.compile_time_s,
            "trace_time_s": self.trace_time_s,
            "flops_per_step": self.flops_per_step,
            "peak_flops_total": self.peak_flops_total,
            "mfu_peak_source": self.mfu_peak_source,
            "n_devices": self.n_devices,
            "step_time_ms_best": best,
            "step_time_ms_mean": mean,
            "tokens_per_sec_best": max(toks) if toks else None,
            "mfu_best": self.mfu(best / 1e3) if best else None,
        }
        # streaming (full-run, fixed-memory) step-time distribution —
        # the window stats above forget everything past `window` steps
        if self.step_time_hist.count:
            for q in (50, 90, 99):
                p = self.step_time_hist.percentile(q)
                out[f"step_time_ms_p{q}"] = p * 1e3 if p is not None else None
        out.update(self.device_memory())
        out["overlap"] = _trace.overlap_flags()
        out["counters"] = _trace.counters()
        return out

    def summary_lines(self) -> List[str]:
        """Human-readable summary (the Profiler.summary telemetry section)."""
        s = self.summary()
        lines = [f"StepMetrics[{self.name}]: {s['steps']} steps, "
                 f"{s['compiles']} compiles ({s['recompiles']} re), "
                 f"compile {s['compile_time_s']:.2f}s"]
        if s["step_time_ms_best"] is not None:
            lines.append(
                f"  step time best {s['step_time_ms_best']:.2f} ms / "
                f"mean {s['step_time_ms_mean']:.2f} ms")
        if s["tokens_per_sec_best"]:
            lines.append(f"  tokens/sec best {s['tokens_per_sec_best']:.0f}")
        if s["mfu_best"] is not None:
            lines.append(f"  MFU best {s['mfu_best'] * 100:.2f}% "
                         f"({s['flops_per_step']:.3g} FLOPs/step over "
                         f"{s['peak_flops_total']:.3g} peak FLOP/s)")
        cnt = s.get("counters") or {}
        for key in sorted(cnt):
            lines.append(f"  {key}: {cnt[key]:.0f}")
        return lines


_active: Optional[StepMetrics] = None


def set_active(metrics: Optional[StepMetrics]) -> None:
    """Install the process-wide collector :func:`active` returns."""
    global _active
    _active = metrics


def active() -> Optional[StepMetrics]:
    return _active
