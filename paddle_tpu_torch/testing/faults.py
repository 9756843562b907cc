"""Deterministic fault injection for robustness tests (port of
``paddle_tpu/testing/faults.py``).

Library code declares *named injection points* (``faults.inject(
"serve.decode.before", rids=rids)`` or ``if faults.fires("serve.preempt")``)
at the places where production failures land: every stage of the
checkpoint write/publish protocol, the serving engine's scheduling loop.
Tests *arm* a point with a seeded trigger and an action; everything is
replayable from the seed — no wall-clock, no real signals needed.

Serving-engine points (ctx carries ``rid``/``rids``):

  crash matrix (outside the quarantine boundary — a ``raise`` here
  kills the engine, exercising journal recovery):
    ``serve.admit.before`` / ``serve.admit.after``  around the submit
    decision+journal append; ``serve.prefill.before`` /
    ``serve.prefill.after`` around one prefill chunk;
    ``serve.decode.before`` / ``serve.decode.after`` around one decode
    batch; ``serve.swap.before`` / ``serve.swap.after`` around a live
    weight swap.
  poison (inside the quarantine boundary — failures here are
  attributed to one request, which is quarantined):
    ``serve.prefill.poison`` (any exception quarantines the prefilling
    request), ``serve.decode.poison`` (raise
    ``engine.PoisonError(ctx["rids"][i])`` from a corrupt callable to
    poison one batch row), and ``serve.prefill.logits`` /
    ``serve.decode.logits`` (ctx carries the DEVICE logits tensor: a
    corrupting action writes into it before the on-device finite
    screen, and no full-logits host copy is made for it).
  control flow: ``serve.preempt`` (graceful stop), ``serve.
  preempt_storm`` (forced eviction).

Actions
    ``raise``    raise :class:`FaultError` at the point (a crashed save,
                 an OOM, a preempted pod — anything that unwinds).
    ``delay``    sleep ``delay_s`` at the point (a slow NFS write, a
                 straggler) — used to hold a window open so a racing
                 thread can be observed inside it.
    ``corrupt``  call ``corrupt(ctx)``, the plan's own callable:
                 corrupted device logits, a poisoned batch row, or
                 :func:`corrupt_array_file` for a checkpoint's leaf files
                 (torn writes, bitrot).
    ``fire``     no side effect; the point's :func:`fires` returns True
                 (control-flow faults: forced evictions, preemption).

Triggers are evaluated per *hit* of the point: ``nth=k`` fires on the
k-th hit exactly (1-based), ``p=0.3, seed=7`` fires Bernoulli(p) from a
private seeded RNG. ``max_fires`` (default 1) caps total firings so a
``raise`` plan does not also kill the retry that the test is trying to
observe. Disarmed points cost one global-flag check.

Arming requires the ``PADDLE_TPU_TORCH_FAULTS`` env gate — a stray import can
never leave fault hooks live in production.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import envs

__all__ = ["FaultError", "FaultPlan", "arm", "disarm", "scope", "inject",
           "fires", "plan_for", "corrupt_array_file", "ENV_FAULTS"]

ENV_FAULTS = "PADDLE_TPU_TORCH_FAULTS"


class FaultError(RuntimeError):
    """The injected failure. Tests assert on this type so an injected
    crash is never confused with a real bug in the code under test."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class FaultPlan:
    """One armed injection point. Mutable counters are lock-protected:
    points may be hit from more than one thread."""

    def __init__(self, point: str, action: str, nth: Optional[int],
                 p: Optional[float], seed: int, delay_s: float,
                 corrupt: Optional[Callable[[Dict[str, Any]], None]],
                 max_fires: Optional[int]):
        if action not in ("raise", "delay", "corrupt", "fire"):
            raise ValueError(f"unknown fault action {action!r}")
        if (nth is None) == (p is None):
            raise ValueError("exactly one of nth= / p= selects the trigger")
        if action == "corrupt" and corrupt is None:
            raise ValueError("a 'corrupt' plan needs its corrupt= callable")
        self.point = point
        self.action = action
        self.nth = nth
        self.p = p
        self.rng = np.random.RandomState(seed)
        self.delay_s = delay_s
        self.corrupt = corrupt
        self.max_fires = max_fires
        self.hits = 0
        self.fired = 0
        self._lock = threading.Lock()

    def _triggered(self) -> bool:
        with self._lock:
            self.hits += 1
            if self.max_fires is not None and self.fired >= self.max_fires:
                return False
            if self.nth is not None:
                hot = self.hits == self.nth
            else:
                hot = bool(self.rng.random_sample() < self.p)
            if hot:
                self.fired += 1
            return hot


_LOCK = threading.Lock()
_PLANS: Dict[str, List[FaultPlan]] = {}
_ARMED = False  # fast-path flag: inject()/fires() bail on this alone


def arm(point: str, action: str = "raise", *, nth: Optional[int] = 1,
        p: Optional[float] = None, seed: int = 0, delay_s: float = 0.05,
        corrupt: Optional[Callable[[Dict[str, Any]], None]] = None,
        max_fires: Optional[int] = 1) -> FaultPlan:
    """Arm `point` with an action + seeded trigger; returns the plan (its
    ``hits``/``fired`` counters let tests assert the point was reached).
    Requires the ``PADDLE_TPU_TORCH_FAULTS`` gate."""
    if not envs.get(ENV_FAULTS):
        raise RuntimeError(
            f"fault injection is gated: set {ENV_FAULTS}=1 to arm points")
    if p is not None:
        nth = None
    plan = FaultPlan(point, action, nth, p, seed, delay_s, corrupt,
                     max_fires)
    global _ARMED
    with _LOCK:
        _PLANS.setdefault(point, []).append(plan)
        _ARMED = True
    return plan


def disarm(point: Optional[str] = None) -> None:
    """Remove the plans for `point` (all points when None)."""
    global _ARMED
    with _LOCK:
        if point is None:
            _PLANS.clear()
        else:
            _PLANS.pop(point, None)
        _ARMED = bool(_PLANS)


@contextlib.contextmanager
def scope(point: str, action: str = "raise", **kw):
    """Context-managed :func:`arm` — disarms the point on exit, so a
    failed assertion never leaks a live fault into the next test."""
    plan = arm(point, action, **kw)
    try:
        yield plan
    finally:
        with _LOCK:
            plans = _PLANS.get(point)
            if plans is not None:
                try:
                    plans.remove(plan)
                except ValueError:
                    pass
                if not plans:
                    _PLANS.pop(point, None)
            global _ARMED
            _ARMED = bool(_PLANS)


def plan_for(point: str) -> List[FaultPlan]:
    with _LOCK:
        return list(_PLANS.get(point, ()))


def _act(plan: FaultPlan, ctx: Dict[str, Any]) -> bool:
    if plan.action == "raise":
        raise FaultError(plan.point, plan.hits)
    if plan.action == "delay":
        time.sleep(plan.delay_s)
        return True
    if plan.action == "corrupt":
        plan.corrupt(ctx)
        return True
    return True  # "fire"


def inject(point: str, **ctx) -> None:
    """Library-side hook: no-op unless `point` is armed and its trigger
    fires. ``ctx`` (paths etc.) is handed to corrupt actions."""
    if not _ARMED:
        return
    for plan in plan_for(point):
        if plan._triggered():
            _act(plan, ctx)


def fires(point: str, **ctx) -> bool:
    """Control-flow hook: True when an armed plan triggers at this hit
    (``raise`` plans still raise). Disarmed points return False."""
    if not _ARMED:
        return False
    hot = False
    for plan in plan_for(point):
        if plan._triggered():
            hot = _act(plan, ctx) or hot
    return hot



def corrupt_array_file(ctx: Dict[str, Any]) -> str:
    """Flip 64 bytes in the middle of the largest non-JSON file under
    ``ctx['dir']``: in a checkpoint directory of
    ``paddle_tpu_torch.distributed.checkpoint``, its largest leaf file (a
    torn write). Returns the corrupted path."""
    import os
    root = ctx["dir"]
    victims = []
    for dirpath, _, filenames in os.walk(root):
        for fn in filenames:
            if fn.endswith(".json"):
                continue
            p = os.path.join(dirpath, fn)
            victims.append((os.path.getsize(p), p))
    if not victims:
        raise RuntimeError(f"no array files to corrupt under {root!r}")
    _, path = max(victims)
    size = os.path.getsize(path)
    off = max(0, size // 2 - 32)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = bytearray(f.read(64))
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path
