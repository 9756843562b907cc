"""Request-lifecycle tracing for the serving engine (port of
``paddle_tpu/observability/request_trace.py``).

Every engine request gets a trace id and a span tree — queue wait,
admission, each chunked-prefill slice, each decode iteration it
participated in, eviction and re-prefill recompute — recorded entirely
host-side. The engine hands the tracer ``time.perf_counter()`` values it
ALREADY captures at iteration boundaries (``step()``'s phase clocks), so
tracing adds no device syncs and no new clock reads on the hot path, and
never feeds back into scheduling: deterministic replay produces
bit-identical tokens with tracing on or off (pinned by test).

The hot path appends one tuple per event — a decode batch is a SINGLE
tuple carrying the participating rids, expanded to per-request spans
only at query/export time — so recording costs nanoseconds per
iteration.

Exports:

- ``export_jsonl(path)`` — one span per line for programmatic analysis;
- ``export_chrome(path)`` — Chrome trace-event JSON through the same
  writer the profiler uses (``exporters.write_chrome_trace``), laid out
  so Perfetto renders one row per engine phase (admit/prefill/decode)
  and one row per request, with eviction as instant markers.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from .exporters import JsonlWriter, write_chrome_trace

__all__ = ["RequestTracer", "PHASE_TIDS", "REQUEST_TID_BASE"]

# Perfetto row layout: engine phases on low tids, requests on 10+rid.
PHASE_TIDS = {"admit": 0, "prefill": 1, "decode": 2}
REQUEST_TID_BASE = 10


class RequestTracer:
    """Span collector for one engine run.

    Internally spans are tuples ``(rid, name, cat, t0, t1, args)`` with
    times in raw ``perf_counter`` seconds; ``rid`` is None for
    engine-phase spans and a tuple of rids for decode batches. Queries
    and exports materialize plain dicts ``{trace_id, rid, name, cat,
    t0, t1, args}`` (decode batches as one span per participant) and
    rebase times onto the earliest timestamp seen so traces start at
    t=0.
    """

    def __init__(self):
        self._spans: List[Tuple] = []
        self._queue_from: Dict[int, float] = {}   # rid -> submit time
        self._chunk_idx: Dict[int, int] = {}      # rid -> prefill chunks so far
        self._epoch: Optional[float] = None

    # -- recording (engine event surface) ------------------------------------

    def _span(self, rid, name: str, cat: str, t0: float, t1: float,
              args: Optional[Dict[str, Any]]) -> None:
        if self._epoch is None or t0 < self._epoch:
            self._epoch = t0
        self._spans.append((rid, name, cat, t0, t1, args))

    def submit(self, rid: int, t: float) -> None:
        """Request entered the waiting queue; opens its queue-wait span."""
        self._queue_from[rid] = t
        if self._epoch is None or t < self._epoch:
            self._epoch = t

    def admit(self, rid: int, t: float, n_preempted: int = 0) -> None:
        """Request admitted: closes the pending queue-wait span."""
        t0 = self._queue_from.pop(rid, t)
        name = "requeue" if n_preempted else "queue"
        self._span(rid, name, "queue", t0, t, {"n_preempted": n_preempted})

    def prefill_chunk(self, rid: int, t0: float, t1: float, n_tokens: int,
                      recompute: bool) -> None:
        """One chunked-prefill slice; ``recompute`` marks post-eviction
        re-prefill of already-generated context."""
        i = self._chunk_idx.get(rid, 0)
        self._chunk_idx[rid] = i + 1
        cat = "reprefill" if recompute else "prefill"
        self._span(rid, f"{cat}[{i}]", cat, t0, t1, {"n_tokens": n_tokens})

    def decode(self, rids: List[int], t0: float, t1: float,
               iteration: int) -> None:
        """One decode batch: a single tuple now, one span per
        participating request's row at export. Inlined append — this is
        the per-iteration hot path."""
        if self._epoch is None or t0 < self._epoch:
            self._epoch = t0
        self._spans.append((tuple(rids), "decode", "decode", t0, t1,
                            {"iteration": iteration, "batch": len(rids)}))

    def evict(self, rid: int, t: float, n_preempted: int) -> None:
        """Preemption: instant marker on the request row, then the request
        waits again (queue-wait span reopens until readmission)."""
        self._span(rid, "evict", "evict", t, t, {"n_preempted": n_preempted})
        self._queue_from[rid] = t

    def finish(self, rid: int, t: float, n_generated: int) -> None:
        self._span(rid, "finish", "finish", t, t,
                   {"n_generated": n_generated})
        self._chunk_idx.pop(rid, None)

    def reject(self, rid: int, t: float, cause: str) -> None:
        """Admission rejection: instant marker — the request never made
        it into the waiting queue, so no queue span opens."""
        self._span(rid, "reject", "reject", t, t, {"cause": cause})

    def shed(self, rid: int, t: float, cause: str) -> None:
        """Deadline shed: closes the request's pending queue-wait span
        with the shed cause (it waited, then the scheduler gave up)."""
        t0 = self._queue_from.pop(rid, t)
        self._span(rid, "shed", "shed", t0, t, {"cause": cause})
        self._chunk_idx.pop(rid, None)

    def quarantine(self, rid: int, t: float, cause: str) -> None:
        """Poison quarantine: instant failure marker on the request row."""
        self._queue_from.pop(rid, None)
        self._span(rid, "quarantine", "quarantine", t, t, {"cause": cause})
        self._chunk_idx.pop(rid, None)

    def phase(self, name: str, t0: float, t1: float, iteration: int) -> None:
        """Engine-phase span (admit/prefill/decode) for one iteration.
        Inlined append — called up to three times per iteration."""
        if t1 > t0:
            if self._epoch is None or t0 < self._epoch:
                self._epoch = t0
            self._spans.append((None, name, "phase", t0, t1,
                                {"iteration": iteration}))

    # -- materialization -------------------------------------------------------

    def _iter_dicts(self) -> Iterator[Dict[str, Any]]:
        """Expand the tuple log into per-request span dicts (decode
        batches fan out to one span per participant)."""
        for rid, name, cat, t0, t1, args in self._spans:
            args = args or {}
            if isinstance(rid, tuple):
                for r in rid:
                    yield {"trace_id": f"req-{r}", "rid": r, "name": name,
                           "cat": cat, "t0": t0, "t1": t1, "args": args}
            else:
                tid = f"req-{rid}" if rid is not None else "engine"
                yield {"trace_id": tid, "rid": rid, "name": name,
                       "cat": cat, "t0": t0, "t1": t1, "args": args}

    @property
    def spans(self) -> List[Dict[str, Any]]:
        """Materialized span dicts (cold path — tests and exports)."""
        return list(self._iter_dicts())

    # -- queries (tests / dryrun asserts) -------------------------------------

    def request_ids(self) -> List[int]:
        out = set()
        for rid, *_ in self._spans:
            if isinstance(rid, tuple):
                out.update(rid)
            elif rid is not None:
                out.add(rid)
        return sorted(out)

    def tree(self, rid: int) -> Dict[str, Any]:
        """Span tree for one request: a root covering its lifetime with the
        time-ordered child spans nested under it."""
        children = sorted((s for s in self._iter_dicts() if s["rid"] == rid),
                          key=lambda s: (s["t0"], s["t1"]))
        if not children:
            raise KeyError(f"no spans recorded for request {rid}")
        return {
            "trace_id": f"req-{rid}",
            "request_id": rid,
            "t0": children[0]["t0"],
            "t1": children[-1]["t1"],
            "children": children,
        }

    # -- export ---------------------------------------------------------------

    def _rel(self, t: float) -> float:
        return t - (self._epoch or 0.0)

    def to_jsonl_records(self) -> List[Dict[str, Any]]:
        recs = []
        for s in sorted(self._iter_dicts(),
                        key=lambda s: (s["t0"], s["t1"])):
            recs.append({
                "trace_id": s["trace_id"], "rid": s["rid"],
                "name": s["name"], "cat": s["cat"],
                "t0_s": self._rel(s["t0"]),
                "dur_s": s["t1"] - s["t0"],
                **s["args"],
            })
        return recs

    def export_jsonl(self, path: str) -> str:
        w = JsonlWriter(path)
        try:
            for rec in self.to_jsonl_records():
                w.write(rec)
        finally:
            w.close()
        return path

    def to_chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event list: ``M`` thread-name metadata + ``X``
        duration spans (+ ``i`` instants for evict/finish), µs timebase."""
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "paddle_tpu_torch.serve"}},
        ]
        for name, tid in sorted(PHASE_TIDS.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": f"engine/{name}"}})
        for rid in self.request_ids():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": REQUEST_TID_BASE + rid,
                           "args": {"name": f"request {rid}"}})
        for s in sorted(self._iter_dicts(),
                        key=lambda s: (s["t0"], s["t1"])):
            if s["rid"] is None:
                tid = PHASE_TIDS.get(s["name"], PHASE_TIDS["decode"])
            else:
                tid = REQUEST_TID_BASE + s["rid"]
            ev = {"name": s["name"], "ts": self._rel(s["t0"]) * 1e6,
                  "pid": 0, "tid": tid, "cat": s["cat"],
                  "args": dict(s["args"])}
            if s["t1"] > s["t0"]:
                ev["ph"] = "X"
                ev["dur"] = (s["t1"] - s["t0"]) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return events

    def export_chrome(self, path: str) -> str:
        return write_chrome_trace(path, self.to_chrome_events())

    # -- SLO helper -----------------------------------------------------------

    def span_count(self, cat: Optional[str] = None) -> int:
        """Number of materialized spans (decode batches count once per
        participating request), optionally filtered by category."""
        if cat is None:
            return sum(len(rid) if isinstance(rid, tuple) else 1
                       for rid, *_ in self._spans)
        return sum(1 for s in self._iter_dicts() if s["cat"] == cat)


def spans_overlap(spans: List[Dict[str, Any]]) -> bool:
    """True when any two duration spans in ``spans`` overlap in time —
    sanity helper for per-row layout tests (a request is only ever in one
    engine phase at a time, so its row must be overlap-free)."""
    ivs = sorted((s["t0"], s["t1"]) for s in spans if s["t1"] > s["t0"])
    latest_end = None
    for t0, t1 in ivs:
        if latest_end is not None and t0 < latest_end:
            return True
        latest_end = t1 if latest_end is None else max(latest_end, t1)
    return False
