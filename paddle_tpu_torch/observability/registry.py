"""Unified metrics registry: one Prometheus exposition (port of
``paddle_tpu/observability/registry.py``, unchanged, so an engine
replay renders the same bytes on both sides).

``MetricsRegistry`` is the single code path: counters, gauges (stored
value or a zero-argument callable read at render time), LogHistogram-
backed summaries, and labeled families of any of those, all rendered by
one ``render_prometheus()`` that emits spec-compliant ``# HELP``/
``# TYPE`` comment pairs ahead of each family's samples, escapes label
values, and keeps histogram ``le`` buckets cumulative (the bucket
assembly is shared with the legacy dict renderer via
``histogram.histogram_sample_lines``, so engine output stayed
byte-identical modulo the comment lines — pinned by a golden test).

Registering the same metric name twice raises: silent shadowing is how
two subsystems end up scraping each other's numbers.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .histogram import (LogHistogram, _prom_name, _prom_num,
                        histogram_sample_lines)

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Summary", "Family"]

_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(value: str) -> str:
    return "".join(_LABEL_ESCAPES.get(ch, ch) for ch in str(value))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(labelnames: Sequence[str],
                   labelvalues: Sequence[str]) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in zip(labelnames, labelvalues))


class Counter:
    """Monotone counter. ``inc()`` only goes up; negative deltas raise."""

    kind = "counter"

    def __init__(self) -> None:
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, "
                             f"got {amount}")
        self._value += float(amount)

    def get(self) -> float:
        return self._value


class Gauge:
    """Settable scalar, or a live view over ``fn()`` read at render time."""

    kind = "gauge"

    def __init__(self, fn: Optional[Callable[[], Union[int, float]]] = None):
        self._fn = fn
        self._value: Union[int, float] = 0.0

    def set(self, value: Union[int, float]) -> None:
        if self._fn is not None:
            raise ValueError("callback gauge cannot be set()")
        self._value = value

    def inc(self, amount: float = 1.0) -> None:
        self.set(self._value + amount)

    def get(self) -> Union[int, float]:
        return self._fn() if self._fn is not None else self._value


class Summary:
    """LogHistogram-backed distribution (rendered as a histogram family).

    Pass ``hist=`` to expose an EXISTING LogHistogram by reference (the
    engine's live SLO histograms register this way — zero double
    bookkeeping), or omit it for a fresh one with the given geometry.
    """

    kind = "histogram"

    def __init__(self, hist: Optional[LogHistogram] = None,
                 lo: float = 1e-4, hi: float = 1e4,
                 bins_per_decade: int = 16):
        self.hist = hist if hist is not None else LogHistogram(
            lo=lo, hi=hi, bins_per_decade=bins_per_decade)

    def observe(self, value: float) -> None:
        self.hist.record(value)

    def get(self) -> LogHistogram:
        return self.hist


_FACTORIES = {"counter": Counter, "gauge": Gauge, "histogram": Summary}


class Family:
    """A labeled family: one metric name, one child per label-value set.

    >>> fam = registry.family("hop_ms", "gauge", labelnames=("site",))
    >>> fam.labels(site="tp_ring").set(3.2)

    Children are created on first use and keyed by their label values in
    ``labelnames`` order; every sample line carries the escaped labels.
    """

    def __init__(self, name: str, kind: str, labelnames: Sequence[str],
                 help: str = ""):
        if kind not in _FACTORIES:
            raise ValueError(f"unknown metric kind {kind!r}")
        if not labelnames:
            raise ValueError("a Family needs at least one label name")
        for ln in labelnames:
            if _prom_name(ln) != ln:
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"family {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _FACTORIES[self.kind]()
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Named registry of metrics with one Prometheus text exposition.

    Metric names are registered WITHOUT the prefix; ``render_prometheus``
    prepends ``prefix_`` and sanitizes. Families iterate in sorted-name
    order interleaved with scalar metrics, matching the legacy dict
    renderer's ``sorted(keys)`` order so migrated surfaces keep their
    line order.
    """

    def __init__(self, prefix: str = "paddle_tpu"):
        self.prefix = prefix
        self._metrics: Dict[str, Union[Counter, Gauge, Summary, Family]] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- registration --------------------------------------------------------

    def _register(self, name: str, metric, help: str):
        with self._lock:
            if name in self._metrics:
                raise ValueError(
                    f"duplicate metric registration: {name!r} is already "
                    f"a {self._metrics[name].kind}")
            self._metrics[name] = metric
            self._help[name] = help
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(name, Counter(), help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], Union[int, float]]] = None) -> Gauge:
        return self._register(name, Gauge(fn=fn), help)

    def summary(self, name: str, help: str = "",
                hist: Optional[LogHistogram] = None, lo: float = 1e-4,
                hi: float = 1e4, bins_per_decade: int = 16) -> Summary:
        return self._register(
            name, Summary(hist=hist, lo=lo, hi=hi,
                          bins_per_decade=bins_per_decade), help)

    def family(self, name: str, kind: str, labelnames: Sequence[str],
               help: str = "") -> Family:
        return self._register(name, Family(name, kind, labelnames, help),
                              help)

    # -- views ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Plain dict view in registration order: LogHistograms for
        summaries, current numbers for counters/gauges (callback gauges
        are invoked), ``{labelvalues: value}`` sub-dicts for families.
        The engine's ``metrics_snapshot()`` is exactly this."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in items:
            if isinstance(m, Family):
                out[name] = {k: (c.get() if not isinstance(c, Summary)
                                 else c.hist)
                             for k, c in m.children()}
            else:
                out[name] = m.get()
        return out

    @classmethod
    def merge(cls, registries: Sequence[Tuple[str, "MetricsRegistry"]],
              label: str = "replica") -> str:
        """Render N registries into ONE Prometheus text block with a
        ``label=`` sample label distinguishing the sources: the fleet
        exposition, where each serving replica's engine registry merges
        into one scrape carrying ``replica="i"`` on every sample line
        (histogram buckets via the shared assembler, so per-replica
        bucket lines stay byte-compatible with a lone engine's, modulo
        the added label).

        The same metric name appearing in several registries is
        label-split — that IS the merge. The same name with a DIFFERENT
        kind or help text is a collision and raises: silent shadowing
        is how two subsystems end up scraping each other's numbers.
        Duplicate label values raise for the same reason.
        """
        if _prom_name(label) != label:
            raise ValueError(f"invalid label name {label!r}")
        decls: Dict[str, Tuple[str, str]] = {}   # full -> (kind, help)
        samples: Dict[str, List[str]] = {}
        seen_values: set = set()
        for value, reg in registries:
            value = str(value)
            if value in seen_values:
                raise ValueError(
                    f"merge(): duplicate {label} label value {value!r}")
            seen_values.add(value)
            with reg._lock:
                items = list(reg._metrics.items())
                helps = dict(reg._help)
            lab = f'{label}="{_escape_label(value)}"'
            for name, m in items:
                full = _prom_name(f"{reg.prefix}_{name}" if reg.prefix
                                  else name)
                help_text = helps.get(name, "")
                if full in decls:
                    kind0, help0 = decls[full]
                    if kind0 != m.kind or help0 != help_text:
                        raise ValueError(
                            f"merge(): metric {full!r} collides across "
                            f"registries ({kind0!r}/{help0!r} vs "
                            f"{m.kind!r}/{help_text!r}); only identical "
                            f"declarations label-split")
                else:
                    decls[full] = (m.kind, help_text)
                out = samples.setdefault(full, [])
                if isinstance(m, Family):
                    if label in m.labelnames:
                        raise ValueError(
                            f"merge(): family {full!r} already carries "
                            f"a {label!r} label")
                    for values_, child in m.children():
                        labels = lab + "," + _render_labels(
                            m.labelnames, values_)
                        if isinstance(child, Summary):
                            out.extend(histogram_sample_lines(
                                full, child.hist, labels=labels))
                        else:
                            out.append(
                                f"{full}{{{labels}}} "
                                f"{_prom_num(float(child.get()))}")
                elif isinstance(m, Summary):
                    out.extend(histogram_sample_lines(full, m.hist,
                                                      labels=lab))
                else:
                    v = m.get()
                    if v is None:
                        continue
                    out.append(f"{full}{{{lab}}} "
                               f"{_prom_num(float(v))}")
        lines: List[str] = []
        for full in sorted(decls):
            kind, help_text = decls[full]
            if help_text:
                lines.append(f"# HELP {full} {_escape_help(help_text)}")
            lines.append(f"# TYPE {full} {kind}")
            lines.extend(samples[full])
        return "\n".join(lines) + "\n"

    def render_prometheus(self) -> str:
        """The single text exposition: per family (sorted by name), a
        ``# HELP`` line (when help text was given), the ``# TYPE`` line,
        then the samples — scalar, labeled, or cumulative-``le``
        histogram lines via the shared bucket assembler."""
        with self._lock:
            items = sorted(self._metrics.items())
            helps = dict(self._help)
        lines: List[str] = []
        for name, m in items:
            full = _prom_name(f"{self.prefix}_{name}" if self.prefix
                              else name)
            if helps.get(name):
                lines.append(f"# HELP {full} {_escape_help(helps[name])}")
            lines.append(f"# TYPE {full} {m.kind}")
            if isinstance(m, Family):
                for values, child in m.children():
                    labels = _render_labels(m.labelnames, values)
                    if isinstance(child, Summary):
                        lines.extend(histogram_sample_lines(
                            full, child.hist, labels=labels))
                    else:
                        lines.append(
                            f"{full}{{{labels}}} "
                            f"{_prom_num(float(child.get()))}")
            elif isinstance(m, Summary):
                lines.extend(histogram_sample_lines(full, m.hist))
            else:
                v = m.get()
                if v is None:
                    continue
                lines.append(f"{full} {_prom_num(float(v))}")
        return "\n".join(lines) + "\n"
