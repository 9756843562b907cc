"""Multi-replica serving fleet: a prefix-affinity router over N engines
(port of ``paddle_tpu/inference/fleet.py``).

:class:`FleetRouter` owns N :class:`InferenceEngine` replicas in one
process over one shared weight tree and turns the engine's robustness
primitives into aggregate throughput:

  - **Prefix-affinity dispatch.** Each submit probes every live
    replica's ``PrefixCache.match_len`` (host-side, a dict walk, no
    device work) and prefers the replica holding the longest cached
    prefix, so shared-system-prompt traffic lands where its COW blocks
    already live and fleet-wide hit rate approaches single-engine hit
    rate instead of 1/N of it.
  - **Load-aware tiebreak.** Among equally-cached replicas (including
    the no-hit case) the router picks by the engines' composite
    ``load_signal()`` (queue depth + in-flight, free blocks, streaming
    TTFT p99) with the replica index as the final tiebreak, so every
    component is deterministic and identical traces route identically.
  - **Spill threshold.** Adversarial prefix skew (all traffic sharing
    one prefix) must not starve N-1 replicas: when the affinity
    winner's queue depth reaches ``spill``, the request spills to the
    least-loaded live replica instead (counted as a rebalance).
  - **Journal migration.** ``kill_replica()`` simulates a crash (the
    journal fd dies unflushed, exactly like a killed process), then
    re-drives the journal's accepted-but-unfinished requests onto
    surviving replicas via :meth:`InferenceEngine.adopt`. Greedy decode
    is deterministic in (prompt + history), so migrated continuation
    streams are bit-identical to the no-failure run and zero accepted
    requests are lost.
  - **Rolling weight swap.** ``request_rolling_swap()`` walks the fleet
    one replica at a time: steer new traffic away, let in-flight work
    drain, ``swap_weights`` at the idle boundary, re-open, next replica.
    The replicas share one weight tree and ``swap_weights`` copies into
    its leaves, so different weights reach every replica at the first
    replica's swap, as they do in the JAX package at mp = 1.
  - **Fleet metrics.** ``render_prometheus()`` merges every replica's
    engine registry into one exposition with a ``replica=`` label
    (:meth:`MetricsRegistry.merge`) plus a fleet-level block: router
    counters (affinity hits, spills, migrations, rolling swaps) and
    aggregates.

Determinism contract: in deterministic mode the fleet clock is the fleet
iteration index, every engine's clock is slaved to it, and routing
consults only scheduler state, so two replays of one trace produce
identical routing decisions, identical per-replica streams, and identical
migration behavior under a seeded kill.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import envs
from ..observability.registry import MetricsRegistry
from .engine import Admission, InferenceEngine, Request, ServeConfig
from .journal import read_journal

__all__ = ["FleetRouter"]

ENV_FLEET_REPLICAS = "PADDLE_TPU_TORCH_FLEET_SERVE_REPLICAS"
ENV_FLEET_SPILL = "PADDLE_TPU_TORCH_FLEET_SERVE_SPILL"
ENV_FLEET_JOURNAL_DIR = "PADDLE_TPU_TORCH_FLEET_SERVE_JOURNAL_DIR"


class FleetRouter:
    """Deterministic two-level router over N engine replicas.

    >>> fleet = FleetRouter(params, config, ServeConfig(), n_replicas=3,
    ...                     journal_dir="journals")
    >>> stats = fleet.run(requests, deterministic=True)

    ``policy="affinity"`` (default) is the two-level prefix-affinity /
    load dispatch; ``policy="random"`` routes uniformly from a seeded
    RNG, the baseline affinity's hit rate is compared against. All
    replicas share one weight tree (the engines hold it by reference);
    each owns its KV pools, scheduler state and, with ``journal_dir``,
    its own ``replica_<i>.jsonl`` journal. ``device`` is every engine's
    (None: the card, where ``params`` must already live)."""

    def __init__(self, params: Dict[str, Any], config,
                 serve: Optional[ServeConfig] = None,
                 n_replicas: Optional[int] = None,
                 journal_dir: Optional[str] = None,
                 spill: Optional[int] = None,
                 policy: str = "affinity", seed: int = 0,
                 record_events: bool = False,
                 engine_kw: Optional[Dict[str, Any]] = None,
                 device=None):
        self.n = int(n_replicas if n_replicas is not None
                     else envs.get(ENV_FLEET_REPLICAS))
        if self.n < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n}")
        if policy not in ("affinity", "random"):
            raise ValueError(
                f"policy must be 'affinity' or 'random', got {policy!r}")
        self.policy = policy
        self.spill = int(spill if spill is not None
                         else envs.get(ENV_FLEET_SPILL))
        if self.spill < 1:
            raise ValueError(f"spill must be >= 1, got {self.spill}")
        journal_dir = (journal_dir if journal_dir is not None
                       else envs.get(ENV_FLEET_JOURNAL_DIR))
        self.journal_dir = journal_dir or None
        self.engines: List[InferenceEngine] = []
        for i in range(self.n):
            jp = (os.path.join(self.journal_dir, f"replica_{i}.jsonl")
                  if self.journal_dir else None)
            self.engines.append(InferenceEngine(
                params, config, serve, journal=jp,
                record_events=record_events, device=device,
                **(engine_kw or {})))
        self.alive: List[bool] = [True] * self.n
        self.dead: List[int] = []
        # router-level steering (rolling swap): replicas here stay live
        # and keep serving their in-flight work, but route() skips them
        self._steering: set = set()
        self._swap: Optional[Dict[str, Any]] = None
        self.last_rolling_swap: Optional[Dict[str, Any]] = None
        self._rng = np.random.RandomState(seed)
        self._rid = itertools.count()
        self._clock = 0.0
        self.iteration = 0
        # rid -> replica holding it; rejections keep the refusing replica
        self.assignments: Dict[int, int] = {}
        self.rejected_at: Dict[int, int] = {}
        self.routed = [0] * self.n
        self.routing_log: List[Tuple[int, int, str, bool]] = []
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.spills = 0
        self.migrations = 0
        self.rolling_swaps = 0
        self.registry = MetricsRegistry(prefix="paddle_tpu_fleet")
        self._register_metrics()

    # -- metrics ------------------------------------------------------------

    def _register_metrics(self) -> None:
        r = self.registry
        r.gauge("replicas", fn=lambda: self.n,
                help="configured replica count")
        r.gauge("replicas_live", fn=lambda: sum(self.alive),
                help="replicas currently serving")
        r.gauge("affinity_hits", fn=lambda: self.affinity_hits,
                help="requests routed to a replica holding their prefix")
        r.gauge("affinity_misses", fn=lambda: self.affinity_misses,
                help="requests with no cached prefix on any replica")
        r.gauge("spills", fn=lambda: self.spills,
                help="rebalances away from a saturated affinity replica")
        r.gauge("migrations", fn=lambda: self.migrations,
                help="requests re-driven off a killed replica's journal")
        r.gauge("rolling_swaps", fn=lambda: self.rolling_swaps,
                help="per-replica weight swaps landed by a rolling swap")
        r.gauge("routed_requests", fn=lambda: sum(self.routed),
                help="accepted requests dispatched by the router")
        r.gauge("queue_depth",
                fn=lambda: sum(len(self.engines[i].waiting)
                               for i in range(self.n) if self.alive[i]),
                help="fleet-wide admitted-but-unscheduled requests")
        r.gauge("finished_requests",
                fn=lambda: len([1 for st, _ in self.outcomes().values()
                                if st == "finished"]),
                help="fleet-wide completed requests (unique rids)")
        r.gauge("generated_tokens",
                fn=lambda: sum(len(t) for t in self.streams().values()),
                help="fleet-wide tokens generated by finished requests")

    # -- routing ------------------------------------------------------------

    def _live(self) -> List[int]:
        return [i for i in range(self.n) if self.alive[i]]

    def _load_key(self, i: int) -> Tuple:
        # composite load, replica index last: fully deterministic order
        return self.engines[i].load_signal() + (i,)

    def route(self, req: Request) -> Tuple[int, str]:
        """Pick a replica for ``req``: ``(index, kind)`` where kind is
        the decision path taken (``affinity`` | ``spill`` | ``load`` |
        ``random``). Pure function of scheduler state (plus the seeded
        RNG under ``policy='random'``): replays route identically."""
        live = [i for i in self._live() if i not in self._steering]
        if not live:
            # every live replica is draining for a swap (N=1 fleets):
            # routing away has nowhere to go: keep serving, zero drops
            live = self._live()
        if not live:
            raise RuntimeError("route(): no live replicas")
        if self.policy == "random":
            return live[int(self._rng.randint(len(live)))], "random"
        hits: Dict[int, int] = {}
        for i in live:
            eng = self.engines[i]
            if eng.cache is None:
                hits[i] = 0
            else:
                limit = (len(req.prompt) - 1) // eng.pool.block_size
                hits[i] = eng.cache.match_len(list(req.prompt), limit)
        best = max(hits.values())
        if best > 0:
            cands = sorted(i for i in live if hits[i] == best)
            aff = min(cands, key=self._load_key)
            if (self.engines[aff].load_signal()[0] < self.spill
                    or len(cands) == len(live)):
                self.affinity_hits += 1
                return aff, "affinity"
            # affinity replica saturated: spill by load over the whole
            # live set so N-1 replicas never starve under prefix skew
            self.spills += 1
            return min(live, key=self._load_key), "spill"
        self.affinity_misses += 1
        return min(live, key=self._load_key), "load"

    def submit(self, req: Request) -> Admission:
        """Route and submit one request. Fleet-unique rids are assigned
        here (engines honor a pre-set ``request_id``), so journals and
        outcomes merge without collisions."""
        if req.request_id is None:
            req.request_id = next(self._rid)
        i, kind = self.route(req)
        eng = self.engines[i]
        eng._clock = self._clock
        adm = eng.submit(req)
        self.routing_log.append((req.request_id, i, kind, adm.accepted))
        if adm.accepted:
            self.assignments[req.request_id] = i
            self.routed[i] += 1
        else:
            self.rejected_at[req.request_id] = i
        return adm

    # -- replica kill + journal migration -----------------------------------

    def kill_replica(self, idx: int) -> Dict[str, Any]:
        """Simulate a replica crash and migrate its work.

        The journal fd is abandoned mid-buffer (exactly what the OS
        does to a killed process), the replica leaves the routing set,
        and every accepted-but-unfinished request in its journal is
        rebuilt and re-routed onto survivors via ``adopt()``: tokens
        already journaled ride along, the remainder is re-derived
        bit-identically (greedy determinism). Without a journal the
        in-memory queue migrates instead (drain-style, exact tokens).
        Zero accepted requests are lost either way."""
        if not self.alive[idx]:
            raise ValueError(f"replica {idx} is already dead")
        if sum(self.alive) < 2:
            raise RuntimeError(
                "kill_replica(): no surviving replica to migrate onto")
        eng = self.engines[idx]
        self.alive[idx] = False
        self.dead.append(idx)
        self._steering.discard(idx)
        if eng._journal is not None:
            eng._journal.abandon()
        # host-side block bookkeeping: demote live sequences exactly as
        # run()'s crash path does, so the fleet-wide pool audit stays
        # leak-free (the dead replica's device pools are garbage either
        # way: the journal is the authoritative record)
        while eng.active:
            seq = eng.active.pop()
            eng._release(seq)
            seq.state = "waiting"
            seq.n_cached = 0
            seq.draft_pos = 0
            eng.waiting.insert(0, seq)
        migrated = 0
        if eng.journal_path:
            st = read_journal(eng.journal_path)
            for rid in st.unfinished_rids():
                rec = st.requests[rid]
                req = Request(
                    prompt=rec["prompt"],
                    max_new_tokens=rec["max_new_tokens"],
                    request_id=rid, eos_id=rec.get("eos_id"),
                    arrival=float(rec.get("arrival", 0.0)),
                    priority=int(rec.get("priority", 0)),
                    ttft_deadline=rec.get("ttft_deadline"),
                    deadline=rec.get("deadline"))
                self._migrate(req, st.tokens.get(rid, []))
                migrated += 1
        else:
            for seq in list(eng.waiting):
                self._migrate(seq.req, list(seq.generated))
                migrated += 1
            eng.waiting = []
        return {"replica": idx, "migrated": migrated}

    def _migrate(self, req: Request, generated: Sequence[int]) -> None:
        i, kind = self.route(req)
        eng = self.engines[i]
        eng._clock = self._clock
        eng.adopt(req, generated)
        self.assignments[req.request_id] = i
        self.routed[i] += 1
        self.migrations += 1
        self.routing_log.append((req.request_id, i, f"migrate:{kind}",
                                 True))

    # -- rolling fleet-wide weight swap -------------------------------------

    def request_rolling_swap(self, source) -> None:
        """Start a zero-downtime fleet-wide weight swap: one replica at
        a time is steered out of routing, drains its in-flight work,
        swaps at the idle boundary (nothing in flight: the same safe
        point ``swap_weights(at_iteration=)`` uses), and rejoins. The
        state machine advances one transition per fleet iteration
        inside :meth:`run`."""
        if self._swap is not None:
            raise RuntimeError("a rolling swap is already in progress")
        self._swap = {"source": source, "queue": self._live(),
                      "current": None, "swapped": []}

    def _advance_swap(self) -> None:
        sw = self._swap
        if sw is None:
            return
        cur = sw["current"]
        if cur is not None:
            if not self.alive[cur]:
                # killed mid-drain: its work already migrated, move on
                self._steering.discard(cur)
                sw["current"] = None
            elif self.engines[cur].idle():
                self.engines[cur].swap_weights(sw["source"])
                self.rolling_swaps += 1
                sw["swapped"].append(cur)
                self._steering.discard(cur)
                sw["current"] = None
            else:
                return  # still draining
        while sw["queue"]:
            nxt = sw["queue"].pop(0)
            if not self.alive[nxt]:
                continue
            sw["current"] = nxt
            self._steering.add(nxt)
            return
        self.last_rolling_swap = {"swapped": list(sw["swapped"])}
        self._swap = None

    # -- driving loop -------------------------------------------------------

    def idle(self) -> bool:
        return all(self.engines[i].idle() for i in self._live())

    def run(self, requests: Sequence[Request],
            deterministic: bool = False, max_iterations: int = 100000,
            kill_at: Optional[Tuple[int, int]] = None,
            rolling_swap_at: Optional[int] = None,
            swap_source=None) -> Dict[str, Any]:
        """Drive the fleet until every request finishes (and any rolling
        swap completes). One fleet iteration = one ``step()`` on every
        non-idle live replica, in replica order: lockstep, so the
        deterministic clock (the fleet iteration index) is shared by
        all engines and every scheduling decision replays identically.

        ``kill_at=(iteration, replica)`` kills that replica at the top
        of that fleet iteration (the seeded mid-trace chaos the tests
        and bench drive); ``rolling_swap_at=`` starts a rolling swap of
        ``swap_source`` at that iteration."""
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time.perf_counter()
        while pending or not self.idle() or self._swap is not None:
            if self.iteration >= max_iterations:
                raise RuntimeError("fleet exceeded max_iterations")
            self._clock = (float(self.iteration) if deterministic
                           else time.perf_counter() - t0)
            if (kill_at is not None and self.iteration == int(kill_at[0])
                    and self.alive[int(kill_at[1])]):
                self.kill_replica(int(kill_at[1]))
            if (rolling_swap_at is not None and self._swap is None
                    and self.iteration == int(rolling_swap_at)):
                self.request_rolling_swap(swap_source)
            self._advance_swap()
            while pending and pending[0].arrival <= self._clock:
                self.submit(pending.pop(0))
            stepped = False
            for i in self._live():
                eng = self.engines[i]
                if eng.idle():
                    continue
                eng._clock = self._clock
                eng.step()
                stepped = True
            self.iteration += 1
            if not stepped and pending and not deterministic:
                time.sleep(min(pending[0].arrival - self._clock, 0.01))
        for i in self._live():
            if self.engines[i]._journal is not None:
                self.engines[i]._journal.flush()
        return self.stats()

    # -- aggregate views ----------------------------------------------------

    def streams(self) -> Dict[int, List[int]]:
        """``rid -> generated tokens`` over every finished request in
        the fleet. Dead replicas contribute their pre-kill streams
        (already delivered to clients); a migrated rid that ALSO
        finished pre-kill is overridden by the survivor's identical
        re-derivation (greedy determinism)."""
        out: Dict[int, List[int]] = {}
        for i in self.dead:
            for s in self.engines[i].finished:
                out[s.req.request_id] = list(s.generated)
        for i in self._live():
            for s in self.engines[i].finished:
                out[s.req.request_id] = list(s.generated)
        return out

    def outcomes(self) -> Dict[int, Tuple[str, Optional[str]]]:
        """Total disposition map across the fleet: every request any
        replica ever saw, survivors overriding dead replicas for
        migrated rids. The zero-lost contract is checkable here: every
        accepted rid appears, none in a dangling state."""
        out: Dict[int, Tuple[str, Optional[str]]] = {}
        for i in self.dead:
            out.update(self.engines[i].outcomes())
        for i in self._live():
            out.update(self.engines[i].outcomes())
        return out

    def lost_requests(self) -> List[int]:
        """Accepted rids with NO outcome anywhere in the fleet: the
        zero-lost invariant says this is always empty."""
        oc = self.outcomes()
        return [rid for rid in self.assignments if rid not in oc]

    def stats(self) -> Dict[str, Any]:
        oc = self.outcomes()
        streams = self.streams()
        finished = [rid for rid, (st, _) in oc.items()
                    if st == "finished"]
        routed = sum(self.routed)
        return {
            "replicas": self.n,
            "live": sum(self.alive),
            "policy": self.policy,
            "requests": len(finished),
            "generated_tokens": sum(
                len(streams.get(rid, ())) for rid in finished),
            "iterations": self.iteration,
            "routed": routed,
            "routed_per_replica": list(self.routed),
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "affinity_hit_rate": (self.affinity_hits / routed
                                  if routed else None),
            "spills": self.spills,
            "migrations": self.migrations,
            "rolling_swaps": self.rolling_swaps,
            "lost": len(self.lost_requests()),
            "outcomes": oc,
        }

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    def render_prometheus(self) -> str:
        """One fleet scrape: every replica's engine registry merged
        under a ``replica=`` label, then the fleet-level router block.
        Metric names never collide across the two blocks (engine
        metrics are ``paddle_tpu_serve_*``, fleet ``paddle_tpu_fleet_*``)."""
        merged = MetricsRegistry.merge(
            [(str(i), self.engines[i].registry) for i in range(self.n)],
            label="replica")
        return merged + self.registry.render_prometheus()
