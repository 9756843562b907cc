"""Rolling checkpoint orchestration, preemption handling, verified resume
(port of ``paddle_tpu/distributed/checkpoint/manager.py``).

``save_load`` gives a single crash-safe checkpoint *write*; training needs
the layer above it:

- **rolling step dirs**: ``<root>/step_00000042`` per save, keep-N
  garbage collection of the oldest *complete* dirs (never a dir whose
  async write is still in flight);
- **completion marker + checksums**: a dir counts as a checkpoint only
  once its ``COMMIT.json`` marker is down, and the marker is written
  *after* the publish rename by the writer thread itself
  (``save_state_dict(on_complete=...)``), so a save killed at any stage
  of the write/publish protocol never produces a marker.
  ``manifest.json`` (written inside the tmp dir, before publish) carries
  per-leaf CRC32s; :meth:`CheckpointManager.restore` re-hashes the leaf
  files against it and falls back to the next-older checkpoint on a
  mismatch, so bitrot or a torn write degrades to an older checkpoint
  instead of a corrupted resume;
- **save-interval pacing**: :meth:`CheckpointManager.on_step` issues
  async saves that overlap later training steps (the host snapshot is
  the only blocking part); the next interval's save waits for the
  previous handle first, so at most one write is in flight per manager;
- **preemption**: SIGTERM (or :meth:`CheckpointManager.request_preemption`)
  sets a flag; at the next step boundary the manager finishes the
  in-flight async write (bounded by ``PADDLE_TPU_TORCH_PREEMPT_GRACE``
  seconds), takes one final *synchronous* save of the current state,
  dumps the flight recorder ring, and raises :class:`Preempted` so the
  driving loop unwinds cleanly.

Over ranks (a process group of more than one rank) every call but the
read-only ones is a collective, with the layout of the rank's tree
(``layout=``, a train step's ``step_fn.layout``): a save writes whole
leaves, each rank its own regions (:func:`~.save_load.save_state_dict`),
and only the coordinator writes ``COMMIT.json`` and collects garbage;
a restore re-hashes on the coordinator alone, which names the step every
rank then loads its slice of; a preemption seen on any one rank stops
every rank at the same step boundary (:meth:`CheckpointManager.on_step`
agrees on it every step). The ranks agree through the process group's
store, with a timeout on every wait.

The crash matrix (tests/test_torch_checkpoint_manager.py) arms a fault at
every point in :data:`CRASH_POINTS` in turn, kills a save there, and
asserts :meth:`CheckpointManager.latest` still resolves a complete
checksum-valid checkpoint whose resumed training matches the
uninterrupted losses bitwise.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from ... import envs
from ...testing import faults
from . import save_load as sl

__all__ = ["CheckpointManager", "Preempted", "CRASH_POINTS",
           "COMMIT_POINTS", "MARKER", "ENV_CKPT_KEEP", "ENV_CKPT_INTERVAL",
           "ENV_PREEMPT_GRACE"]

ENV_CKPT_KEEP = "PADDLE_TPU_TORCH_CKPT_KEEP"
ENV_CKPT_INTERVAL = "PADDLE_TPU_TORCH_CKPT_INTERVAL"
ENV_PREEMPT_GRACE = "PADDLE_TPU_TORCH_PREEMPT_GRACE"

MARKER = "COMMIT.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")

# marker-side injection points (the write-side ones live in save_load)
COMMIT_POINTS = ("ckpt.commit.before_marker", "ckpt.commit.after_marker")
CRASH_POINTS = sl.CKPT_WRITE_POINTS + COMMIT_POINTS


class Preempted(RuntimeError):
    """Raised at a step boundary after a graceful preemption shutdown.

    ``step`` is the last completed step; ``checkpoint`` the final sync
    save's dir (None when that save itself failed: resume then falls back
    to the newest older checkpoint via ``latest()``)."""

    def __init__(self, step: int, checkpoint: Optional[str]):
        saved = checkpoint if checkpoint is not None else "no final save"
        super().__init__(f"preempted at step {step} ({saved})")
        self.step = step
        self.checkpoint = checkpoint


class CheckpointManager:
    """Rolling, preemption-aware checkpoints under one root directory.

    Over ranks (the world of the process group; rank 0 the coordinator)
    ``layout`` is the layout of the rank's tree that :meth:`save` and
    :meth:`on_step` write and :meth:`restore` reads by default, and
    ``timeout`` the seconds a rank waits for a peer (default
    :data:`~.save_load.SYNC_TIMEOUT_S`). Every rank makes its own
    manager on the same root, on a file system they share, and calls
    :meth:`save`, :meth:`restore` and :meth:`on_step` in the same
    order.

    A Llama run resumed on the card under the default flash backward
    (``PADDLE_TPU_TORCH_FLASH_BWD=auto``) is close to, not bitwise, the
    run it resumes: that kernel sums dQ in an order that varies between
    runs. Under ``split`` the resume is bitwise."""

    def __init__(self, root: str, keep: Optional[int] = None,
                 interval: Optional[int] = None,
                 grace: Optional[float] = None, layout=None,
                 timeout: Optional[float] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.layout = layout
        self.timeout = timeout
        # the store keys of the last two preemption votes: a rank at vote
        # n has seen every rank finish vote n - 2
        self._votes: collections.deque = collections.deque()
        # seconds of the last restore: the coordinator's verify, the load
        self.last_restore: Dict[str, Any] = {}
        self.keep = int(keep if keep is not None
                        else envs.get(ENV_CKPT_KEEP))
        self.interval = (interval if interval is not None
                         else envs.get(ENV_CKPT_INTERVAL))
        self.grace = float(grace if grace is not None
                           else envs.get(ENV_PREEMPT_GRACE))
        self._lock = threading.Lock()
        self._inflight: Dict[str, sl.AsyncSaveHandle] = {}
        self._last_handle: Optional[sl.AsyncSaveHandle] = None
        self.save_errors: List[Tuple[str, BaseException]] = []
        self._preempt = threading.Event()
        self._signum: Optional[int] = None
        self._prev_handler: Any = None

    def _ranks(self) -> Optional[sl.Ranks]:
        return sl.Ranks.of(timeout=self.timeout)

    def _leads(self) -> bool:
        """Whether this process writes the markers and collects garbage:
        the coordinator over ranks, the one process otherwise."""
        ranks = self._ranks()
        return ranks is None or ranks.is_coordinator

    # -- layout ---------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    def _complete(self, path: str) -> bool:
        """Marker down and manifest parseable: the `latest()` filter.
        (Checksum *verification* is restore-time: it reads the leaves.)"""
        marker = os.path.join(path, MARKER)
        if not os.path.isdir(path) or not os.path.isfile(marker):
            return False
        try:
            with open(marker) as f:
                json.load(f)
        except (OSError, ValueError):
            return False
        man = sl.load_manifest(path)
        return man is not None and "leaf_checksums" in man

    def steps(self) -> List[int]:
        """Complete checkpoint steps under root, ascending."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            m = _STEP_RE.match(n)
            if m and self._complete(os.path.join(self.root, n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        """Newest complete checkpoint step (None when there is none).
        Incomplete dirs (killed saves, in-flight writes) are skipped."""
        steps = self.steps()
        return steps[-1] if steps else None

    def latest_path(self) -> Optional[str]:
        step = self.latest()
        return None if step is None else self.step_dir(step)

    # -- saving ---------------------------------------------------------------

    def _commit_marker(self, path: str, step: int) -> Callable[[], None]:
        def write_marker():
            faults.inject("ckpt.commit.before_marker", dir=path)
            tmp = os.path.join(path, MARKER + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"step": int(step)}, f)
            os.replace(tmp, os.path.join(path, MARKER))
            faults.inject("ckpt.commit.after_marker", dir=path)
            try:
                # the dir just became complete: roll the window now, from
                # the writer thread, so retention never waits for the
                # next save() call
                self.gc()
            except Exception:
                pass  # GC failure must not poison a successful save
        return write_marker

    def _reap(self, h: Optional[sl.AsyncSaveHandle], path: str) -> None:
        """Collect a finished handle's error (a failed rolling save is
        survivable by design: warn, record, keep training)."""
        if h is None:
            return
        try:
            h.wait()
        except BaseException as e:
            self.save_errors.append((path, e))
            warnings.warn(
                f"async checkpoint save to {path!r} failed "
                f"({type(e).__name__}: {e}); continuing, latest() still "
                "resolves the newest complete checkpoint", RuntimeWarning)

    def save(self, state: Dict[str, Any], step: int,
             block: bool = False) -> sl.AsyncSaveHandle:
        """Snapshot `state` now and write ``step_<step>`` asynchronously
        (synchronously with block=True). Paces itself: waits out this
        manager's previous in-flight save first, so saves overlap training
        steps but never each other. Over ranks a collective with this
        rank's shards under the manager's ``layout``; every rank's handle
        resolves with the same outcome, and a fault on any rank's part
        publishes nothing."""
        path = self.step_dir(step)
        with self._lock:
            prev = self._last_handle
            prev_path = next((p for p, h in self._inflight.items()
                              if h is prev), "")
        if prev is not None and not prev.done():
            self._reap(prev, prev_path)
        if os.path.isdir(path) and self._leads():
            # re-saving a step (e.g. a resumed run re-reaches it): replace
            shutil.rmtree(path)
        h = sl.save_state_dict(state, path, async_save=True,
                               manifest={"step": int(step)},
                               on_complete=self._commit_marker(path, step),
                               layout=self.layout, timeout=self.timeout)
        with self._lock:
            self._inflight[path] = h
            self._last_handle = h
        if block:
            try:
                h.wait()
            finally:
                with self._lock:
                    self._inflight.pop(path, None)
        self.gc()
        return h

    def wait(self, timeout: Optional[float] = None
             ) -> List[Tuple[str, BaseException]]:
        """Drain every in-flight save this manager started. Returns the
        (path, error) list of failed saves instead of raising: a dead
        rolling save is the crash matrix's normal case, not a resume
        blocker. TimeoutError (a write still running past `timeout`) does
        propagate: the caller owns the grace budget."""
        with self._lock:
            items = list(self._inflight.items())
        errs = []
        for path, h in items:
            try:
                h.wait(timeout)
            except TimeoutError:
                raise
            except BaseException as e:
                errs.append((path, e))
            with self._lock:
                self._inflight.pop(path, None)
        self.save_errors.extend(errs)
        self.gc()
        return errs

    def gc(self) -> List[str]:
        """Delete the oldest complete checkpoints beyond keep-N. A dir
        whose write is still in flight in this manager is never touched
        (handle check), and incomplete dirs are left alone entirely:
        ``_write_checkpoint`` reclaims its own path's residue on the next
        save, and a second manager may be mid-write in one of them. Over
        ranks only the coordinator collects."""
        if not self._leads():
            return []
        steps = self.steps()
        removed = []
        excess = steps[:-self.keep] if self.keep > 0 else steps
        for st in excess:
            path = self.step_dir(st)
            with self._lock:
                h = self._inflight.get(path)
            if h is not None and not h.done():
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        return removed

    # -- restore --------------------------------------------------------------

    def verify_step(self, step: int) -> bool:
        """Re-hash the checkpoint's leaf files against its manifest CRCs."""
        path = self.step_dir(step)
        man = sl.load_manifest(path)
        if man is None:
            return False
        try:
            leaves = sl._leaf_files(sl.read_tree(path))
            sums = sl.file_checksums((leaf.path, leaf.shape, leaf.dtype)
                                     for leaf in leaves)
        except Exception:
            return False
        return sums == list(man.get("leaf_checksums", []))

    def _choose(self, step: Optional[int], verify: bool):
        """(the newest complete, checksum-valid step of the candidates,
        None) or (None, why none is)."""
        candidates = [int(step)] if step is not None else self.steps()
        tried = []
        for st in reversed(candidates):
            path = self.step_dir(st)
            if not self._complete(path):
                tried.append((st, "incomplete"))
                continue
            if verify and not self.verify_step(st):
                tried.append((st, "checksum mismatch"))
                warnings.warn(
                    f"checkpoint {path!r} failed checksum verification; "
                    "falling back to an older checkpoint", RuntimeWarning)
                continue
            return st, None
        detail = ", ".join(f"step {s}: {why}" for s, why in tried) or "empty"
        return None, (f"no complete checksum-valid checkpoint under "
                      f"{self.root!r} ({detail})")

    def restore(self, state: Dict[str, Any], step: Optional[int] = None,
                verify: bool = True, device=None, layout=None) -> int:
        """Fill `state` (copied into each tensor leaf, on its device) from
        `step`, or from the newest checkpoint that is complete AND
        checksum-valid, falling back older on corruption. Returns the
        restored step. `device` places adopted leaves
        (:func:`~.save_load.load_state_dict`). Over ranks a collective:
        the coordinator alone checks and re-hashes the candidates and
        names the step, every rank then reads its slice of each leaf
        under ``layout`` (None: the manager's), whatever layout and world
        size wrote it, or every rank raises the same
        FileNotFoundError."""
        layout = layout if layout is not None else self.layout
        ranks = self._ranks()
        if ranks is not None and layout is None:
            raise ValueError(
                f"CheckpointManager.restore: a process group of "
                f"{ranks.world} ranks is up and no layout= was given: each "
                f"rank's tree holds its shards; pass the tree's layout (a "
                f"train step's step_fn.layout)")
        t0 = time.perf_counter()
        chosen = why = None
        if ranks is None or ranks.is_coordinator:
            chosen, why = self._choose(step, verify)
        if ranks is not None:
            said = ranks.broadcast(
                sl.op_key("restore", self.root),
                str(chosen) if why is None else f"!{why}",
                f"the coordinator (rank {ranks.coordinator}) to choose the "
                f"step to restore under {self.root!r}")
            chosen, why = (None, said[1:]) if said.startswith("!") \
                else (int(said), None)
        if why is not None:
            raise FileNotFoundError(why)
        t1 = time.perf_counter()
        sl.load_state_dict(state, self.step_dir(chosen), device=device,
                           layout=layout)
        self.last_restore = {"step": chosen, "verify_s": t1 - t0,
                             "load_s": time.perf_counter() - t1}
        return chosen

    # -- preemption -----------------------------------------------------------

    def install_preemption_handler(self, signum: int = signal.SIGTERM) -> None:
        """SIGTERM -> set the preemption flag; the actual shutdown happens
        at the next step boundary (a signal handler must not run device
        code). Keeps the previous handler for uninstall."""
        try:
            self._prev_handler = signal.signal(signum, self._on_signal)
            self._signum = signum
        except ValueError:
            # not the main thread: signals can't be hooked here; callers
            # still preempt via request_preemption()
            warnings.warn(
                "cannot install a signal handler off the main thread; "
                "use request_preemption()", RuntimeWarning)

    def uninstall_preemption_handler(self) -> None:
        if self._signum is not None:
            signal.signal(self._signum, self._prev_handler or signal.SIG_DFL)
            self._signum = None
            self._prev_handler = None

    def _on_signal(self, signum, frame) -> None:
        self._preempt.set()

    def request_preemption(self) -> None:
        """Programmatic preemption (tests, cluster agents without signals)."""
        self._preempt.set()

    @property
    def preempted(self) -> bool:
        return self._preempt.is_set()

    def on_step(self, step: int, state_fn: Callable[[], Dict[str, Any]],
                recorder=None) -> Optional[sl.AsyncSaveHandle]:
        """Per-step hook for a driving loop: handles a pending preemption
        (raises :class:`Preempted`), else issues the interval-paced async
        save. `state_fn` is called only when a save actually happens.
        Over ranks every rank calls it after every step: the ranks agree
        whether any of them was preempted (SIGTERM or
        :meth:`request_preemption` on one rank is enough), so every rank
        takes the final save at the same step and raises the same
        :class:`Preempted`."""
        if self._agree_preempted():
            self._preempt.set()
            self._finalize_preemption(step, state_fn, recorder)
        if self.interval and step % self.interval == 0:
            return self.save(state_fn(), step)
        return None

    def _agree_preempted(self) -> bool:
        ranks = self._ranks()
        if ranks is None:
            return self._preempt.is_set()
        key = sl.op_key("preempt", self.root)
        got = ranks.any(key, self._preempt.is_set(),
                        "every rank at the step boundary")
        self._votes.append(key)
        if len(self._votes) > 2:
            old = self._votes.popleft()
            if ranks.is_coordinator:
                ranks.forget(old)
        return got

    def _finalize_preemption(self, step: int, state_fn, recorder) -> None:
        # 1) let the in-flight async write land (bounded by the grace
        #    budget: a hung write must not eat the whole grace period)
        try:
            self.wait(timeout=self.grace)
        except TimeoutError:
            warnings.warn(
                f"in-flight checkpoint write still running after "
                f"{self.grace}s grace; abandoning it (its dir has no "
                "marker and will be skipped by latest())", RuntimeWarning)
        # 2) one final synchronous save of the current state
        final: Optional[str] = self.step_dir(step)
        try:
            self.save(state_fn(), step, block=True)
        except BaseException as e:
            final = None
            self.save_errors.append((self.step_dir(step), e))
            warnings.warn(
                f"final preemption save failed ({type(e).__name__}: {e}); "
                "resume will use the newest older checkpoint",
                RuntimeWarning)
        # 3) the post-mortem ring: one dump per preemption
        if recorder is not None:
            recorder.dump("preemption")
        raise Preempted(step, final)
