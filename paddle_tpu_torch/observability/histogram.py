"""Fixed-memory log-bucketed streaming histograms for live SLO metrics
(port of ``paddle_tpu/observability/histogram.py``, unchanged).

Percentiles taken once, at the end of a run, from per-sequence
timestamp lists cost O(tokens) memory and give no live view. A
``LogHistogram`` keeps a FIXED array of counters over
log-spaced buckets: ``record()`` is two float ops + one list increment
(no allocation, no device work), ``percentile(q)`` walks the counters,
and the estimate is guaranteed within one bucket of the exact value —
for the default 16 buckets/decade that is a <16% relative error bound,
far inside SLO-dashboard resolution, at a few KB per metric regardless
of traffic.

``render_prometheus`` emits the standard text exposition (cumulative
``_bucket{le=...}`` counts + ``_sum``/``_count``, plain gauges for
scalars) so an operator can scrape an engine snapshot with zero new
dependencies.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

__all__ = ["LogHistogram", "render_prometheus", "histogram_sample_lines"]


class LogHistogram:
    """Streaming histogram over log-spaced buckets [lo, hi).

    Bucket ``i`` covers ``lo * 10**(i/bpd) <= v < lo * 10**((i+1)/bpd)``;
    values below ``lo`` (including zero/negative) land in an underflow
    bucket, values ``>= hi`` in an overflow bucket. Exact ``min``/``max``
    /``sum``/``count`` are tracked alongside, and the extreme buckets
    report those exact values, so p0/p100 never invent mass outside the
    observed range.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e4,
                 bins_per_decade: int = 16):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if bins_per_decade < 1:
            raise ValueError(f"bins_per_decade must be >= 1, "
                             f"got {bins_per_decade}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(bins_per_decade)
        self.n_bins = int(math.ceil(math.log10(hi / lo) * self.bpd))
        # [underflow] + n_bins + [overflow]
        self.counts: List[int] = [0] * (self.n_bins + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- recording -----------------------------------------------------------

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v < self.lo:
            self.counts[0] += 1
        elif v >= self.hi:
            self.counts[-1] += 1
        else:
            idx = int(math.log10(v / self.lo) * self.bpd)
            # float log rounding can land exactly on a boundary; clamp
            idx = min(max(idx, 0), self.n_bins - 1)
            self.counts[idx + 1] += 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (same geometry required)."""
        if (other.lo, other.hi, other.bpd) != (self.lo, self.hi, self.bpd):
            raise ValueError("cannot merge histograms with different "
                             "bucket geometry")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        for v in (other.min, other.max):
            if v is None:
                continue
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
        return self

    # -- geometry ------------------------------------------------------------

    def edge(self, i: int) -> float:
        """Lower edge of bucket ``i`` (0..n_bins inclusive -> upper edge)."""
        return self.lo * 10.0 ** (i / self.bpd)

    # -- quantiles -----------------------------------------------------------

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile estimate; None when empty.

        Returns the geometric midpoint of the bucket holding the rank-q
        sample (exact min/max for the under/overflow buckets), clamped to
        the observed [min, max] — within one bucket of the exact order
        statistic by construction.
        """
        if not self.count:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i == 0:                       # underflow: exact floor
                    est = self.min
                elif i == len(self.counts) - 1:  # overflow: exact ceiling
                    est = self.max
                else:
                    est = math.sqrt(self.edge(i - 1) * self.edge(i))
                return min(max(est, self.min), self.max)
        return self.max  # unreachable; defensive

    def snapshot(self, quantiles=(50, 90, 99)) -> Dict[str, Optional[float]]:
        """Live summary dict: count/sum/min/max/mean + requested p-quantiles."""
        out: Dict[str, Optional[float]] = {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "mean": self.sum / self.count if self.count else None,
        }
        for q in quantiles:
            key = f"p{q:g}".replace(".", "_")
            out[key] = self.percentile(q)
        return out

    def to_dict(self) -> Dict:
        """JSON-ready dump (flight-recorder / JSONL payloads)."""
        return {"lo": self.lo, "hi": self.hi, "bins_per_decade": self.bpd,
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "nonzero_buckets": {str(i): c
                                    for i, c in enumerate(self.counts) if c}}


def _prom_name(name: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_num(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    return repr(float(v))


def histogram_sample_lines(name: str, val: LogHistogram,
                           labels: str = "") -> List[str]:
    """The sample lines of one histogram family (no # comment lines).

    ``labels`` is a pre-rendered ``key="value"`` list (empty for an
    unlabeled family) merged into each ``_bucket`` line ahead of ``le``.
    This is THE bucket-assembly code path: both the legacy dict renderer
    below and ``registry.MetricsRegistry`` call it, so the exposition
    stays byte-identical across the two surfaces.
    """
    sep = labels + "," if labels else ""
    brace = "{" + labels + "}" if labels else ""
    lines: List[str] = []
    # emit only the populated bucket range (plus one flanking
    # bucket each side); the le bounds stay cumulative because the
    # skipped leading buckets are all empty bar underflow, which
    # folds into the first emitted bound
    nz = [i for i in range(1, val.n_bins + 1) if val.counts[i]]
    cum = val.counts[0]
    if nz:
        start = max(1, nz[0] - 1)
        end = min(val.n_bins, nz[-1] + 1)
        for i in range(1, end + 1):
            cum += val.counts[i]
            if i >= start:
                lines.append(
                    f'{name}_bucket{{{sep}le="{_prom_num(val.edge(i))}"}}'
                    f" {cum}")
    lines.append(f'{name}_bucket{{{sep}le="+Inf"}} {val.count}')
    lines.append(f"{name}_sum{brace} {_prom_num(val.sum)}")
    lines.append(f"{name}_count{brace} {val.count}")
    return lines


def render_prometheus(metrics: Dict[str, Union[LogHistogram, float, int]],
                      prefix: str = "paddle_tpu") -> str:
    """Prometheus text exposition of a metric dict.

    ``LogHistogram`` values render as histogram families (cumulative
    ``_bucket{le="..."}`` lines over the non-empty prefix of buckets,
    then ``_sum``/``_count``); plain numbers render as gauges. Keys are
    sanitized to Prometheus metric-name characters.
    """
    lines: List[str] = []
    for key in sorted(metrics):
        val = metrics[key]
        name = _prom_name(f"{prefix}_{key}" if prefix else key)
        if isinstance(val, LogHistogram):
            lines.append(f"# TYPE {name} histogram")
            lines.extend(histogram_sample_lines(name, val))
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_prom_num(float(val))}")
        elif val is None:
            continue
        else:
            raise TypeError(f"metric {key!r}: expected LogHistogram or "
                            f"number, got {type(val).__name__}")
    return "\n".join(lines) + "\n"
