"""Crash-recoverable engine journal (append-only host-side JSONL; port of
``paddle_tpu/inference/journal.py`` with the same record grammar and
flush rules, so a port journal's lines equal the JAX engine's).

Every ACCEPTED
request and every token the engine emits is appended to a journal file,
one JSON record per line, flushed once per scheduler iteration. Greedy
decoding is deterministic in (prompt + generated history), so the
journal never needs to capture device state — a fresh engine replays
the journal into its waiting queue (``InferenceEngine.recover``) and
re-drives each unfinished request through the ordinary preempted-
sequence path; tokens emitted after the journal's last flush are simply
re-derived bit-identically.

Record grammar (``ev`` field):

  ``open``     journal opened (version stamp; ``resume`` marks a
               post-recovery reopen)
  ``submit``   an accepted request: rid + everything needed to rebuild
               the ``Request`` (prompt, limits, deadlines, priority)
  ``reject``   an admission rejection, with its cause (audit only —
               rejected requests are never replayed)
  ``tokens``   tokens emitted since the previous record, in emission
               order: ``[[rid, tok], ...]`` (iterations are coalesced)
  ``finish``   rid completed (written AFTER its final ``tokens`` record,
               so a torn tail can lose the finish mark but never a
               finished request's tokens)
  ``shed``/``failed``  terminal non-success outcomes, with cause
  ``swap``     a live weight swap landed (audit)
  ``recover``  a successor engine adopted this journal

A crash can tear the final line; :func:`read_journal` tolerates (and
counts) undecodable lines. Durability: ADMISSION records (submit /
reject) flush on append — an accepted request can never vanish. Token
pairs coalesce in memory and everything else rides the userspace
buffer (drained in order by the next flushed append, a clean ``run()``
exit, or ``close``), because anything lost with the buffer is
re-derived on recovery: tokens bit-identically from greedy replay,
finish/shed/failed marks by re-hitting the same deterministic
condition. Set ``PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC`` for power-failure
durability at an fsync-per-flush cost.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["EngineJournal", "JournalCompatError", "JournalState",
           "read_journal"]

_VERSION = 1


class JournalCompatError(ValueError):
    """A journal cannot be recovered onto THIS engine configuration.

    Raised up front by ``InferenceEngine.recover()`` — before any state
    is touched — when the successor's ``ServeConfig`` breaks the bit-
    identical re-drive contract: a different ``kv_dtype`` (int8 is the
    documented numeric deviation, so crossing it changes streams), or a
    journaled request that can never fit the successor's ``max_seq_len``
    / block pool. Config differences whose streams are bit-identical
    (prefix caching, speculation) recover freely."""


class EngineJournal:
    """Append-only writer half. One journal belongs to one engine at a
    time; records are single-line JSON, written in logical order but
    SERIALIZED lazily: appends land in an in-memory record buffer
    (token pairs coalesce into the buffer's trailing ``tokens``
    record), and the whole buffer is dumped + written + flushed in one
    batch at each durability point — an admission record, a clean
    ``run()`` exit, ``close``. The per-iteration hot path is a list
    extend; the per-request cost is one ``dict`` construction; the
    syscalls and ``json.dumps`` bill only where durability demands
    them."""

    # backstop cap on buffered records — durability points drain the
    # buffer far sooner in any live engine
    MAX_PENDING = 4096

    def __init__(self, path: str, fsync: bool = False,
                 resume: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.path = path
        self.fsync = bool(fsync)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._buf: List[Dict[str, Any]] = []
        # meta is AUDIT-ONLY engine configuration (e.g. kv_dtype,
        # prefix_cache). Cache state itself is derived, never
        # journaled: recovery re-derives identical bytes from the token
        # record, so replay needs no cache snapshot. read_journal
        # ignores unknown open-record fields by construction.
        self._append({"ev": "open", "version": _VERSION,
                      "resume": bool(resume), **(meta or {})})

    def _write_buf(self) -> None:
        if self._buf:
            recs, self._buf = self._buf, []
            self._f.write("".join(
                json.dumps(r, separators=(",", ":")) + "\n"
                for r in recs))

    def _append(self, rec: Dict[str, Any]) -> None:
        """Durable append: everything buffered so far, then ``rec``, hit
        the OS in order (so a finish mark can never outrun its
        request's tokens)."""
        self._buf.append(rec)
        self.flush()

    def _defer(self, rec: Dict[str, Any]) -> None:
        """Buffered append: serialized at the next durability point. A
        deferred record that dies with the process is re-derived on
        recovery (see the class docstring's durability contract)."""
        self._buf.append(rec)
        if len(self._buf) >= self.MAX_PENDING:
            self._write_buf()

    def submit(self, req) -> None:
        self._append({
            "ev": "submit", "rid": int(req.request_id),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "arrival": float(req.arrival),
            "priority": int(getattr(req, "priority", 0)),
            "ttft_deadline": getattr(req, "ttft_deadline", None),
            "deadline": getattr(req, "deadline", None),
        })

    def reject(self, rid: int, cause: str) -> None:
        self._append({"ev": "reject", "rid": int(rid), "cause": cause})

    def tokens(self, iteration: int,
               pairs: Iterable[Tuple[int, int]]) -> None:
        # the per-iteration hot path: pairs coalesce into the buffer's
        # trailing tokens record — a list extend, no serialization, no
        # syscall. Tokens that die in the buffer are re-derived
        # bit-identically by recover() (greedy decode is deterministic
        # in prompt + history), so nothing durable is lost.
        toks = [[int(r), int(t)] for r, t in pairs]
        if not toks:
            return
        if self._buf and self._buf[-1].get("ev") == "tokens":
            self._buf[-1]["toks"].extend(toks)
        else:
            self._defer({"ev": "tokens", "toks": toks})

    # finish/shed/failed/swap marks are deferred like tokens: if they
    # die with the process, recover() re-queues the request and the
    # successor re-derives the same outcome (finish via done(), shed/
    # failed by re-hitting the same deadline or poison) — nothing is
    # silently dropped as long as the SUBMIT record was durable

    def finish(self, rid: int) -> None:
        self._defer({"ev": "finish", "rid": int(rid)})

    def shed(self, rid: int, cause: str) -> None:
        self._defer({"ev": "shed", "rid": int(rid), "cause": cause})

    def failed(self, rid: int, cause: str) -> None:
        self._defer({"ev": "failed", "rid": int(rid), "cause": cause})

    def swap(self, iteration: int, source: Optional[str]) -> None:
        self._defer({"ev": "swap", "it": int(iteration),
                     "source": source})

    def recovered(self, n_requests: int, torn_lines: int) -> None:
        self._append({"ev": "recover", "n_requests": int(n_requests),
                      "torn_lines": int(torn_lines)})

    def flush(self) -> None:
        """Serialize the buffer and push everything to the OS — called
        by every durable append and once per clean ``run()`` exit, so
        an idle journal is always complete on disk."""
        self._write_buf()
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def discard_pending(self) -> None:
        """Drop buffered records without writing them. recover() calls
        this on a journal that survived an in-process crash: buffered
        tokens/marks predate the recovery read, and draining them AFTER
        it would duplicate those streams in the file."""
        self._buf = []

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def abandon(self) -> None:
        """Crash-simulation close: drop the buffered records and close
        the fd WITHOUT flushing — exactly what the OS does to a killed
        process. What dies with the buffer (tokens, finish marks) is
        re-derived by recovery; durable appends already hit the OS.
        Used by the fleet's ``kill_replica`` so a killed replica's
        journal looks like a real crash, torn tail and all."""
        self._buf = []
        if not self._f.closed:
            self._f.close()


@dataclasses.dataclass
class JournalState:
    """Parsed journal: everything a successor engine needs to re-drive."""
    requests: Dict[int, Dict[str, Any]]   # rid -> submit record, in order
    tokens: Dict[int, List[int]]          # rid -> emitted tokens, in order
    finished: Set[int]
    rejected: Dict[int, str]              # rid -> cause
    shed: Dict[int, str]
    failed: Dict[int, str]
    swaps: int = 0
    torn_lines: int = 0
    # the FIRST open record's audit fields (kv_dtype, prefix_cache,
    # speculative, mp) — the configuration that produced the journaled
    # tokens; recover() checks successor compatibility against it
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def terminal_rids(self) -> Set[int]:
        return (self.finished | set(self.shed) | set(self.failed)
                | set(self.rejected))

    def unfinished_rids(self) -> List[int]:
        """Accepted requests with no terminal record, in submit order."""
        term = self.terminal_rids()
        return [rid for rid in self.requests if rid not in term]


def read_journal(path: str) -> JournalState:
    """Parse a journal, tolerating a torn tail: undecodable lines are
    counted in ``torn_lines`` and skipped (a crash mid-``write`` can only
    corrupt trailing data; every intact record stands on its own)."""
    st = JournalState(requests={}, tokens={}, finished=set(),
                      rejected={}, shed={}, failed={})
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                st.torn_lines += 1
                continue
            ev = rec.get("ev")
            if ev == "submit":
                rid = int(rec["rid"])
                st.requests[rid] = rec
                st.tokens.setdefault(rid, [])
            elif ev == "tokens":
                for r, t in rec.get("toks", ()):
                    st.tokens.setdefault(int(r), []).append(int(t))
            elif ev == "finish":
                st.finished.add(int(rec["rid"]))
            elif ev == "reject":
                st.rejected[int(rec["rid"])] = rec.get("cause", "")
            elif ev == "shed":
                st.shed[int(rec["rid"])] = rec.get("cause", "")
            elif ev == "failed":
                st.failed[int(rec["rid"])] = rec.get("cause", "")
            elif ev == "swap":
                st.swaps += 1
            elif ev == "open" and not st.meta:
                # the ORIGINAL writer's configuration; resume reopens
                # append later open records but never shadow the first
                st.meta = {k: v for k, v in rec.items()
                           if k not in ("ev", "version", "resume")}
            # recover records carry no replay state
    return st
