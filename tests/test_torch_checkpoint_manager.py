"""The port's CheckpointManager (paddle_tpu_torch.distributed.checkpoint
.manager) against paddle_tpu's, on the CPU: the crash matrix, rolling GC,
completeness, interval pacing, checksum fallback and preemption.

A tiny fp32 Llama (2 layers, GQA 4/2, vocab 96) trains through the port's
``build_train_step`` (its kernels' plain versions on CPU tensors) from
the JAX ``build_train_step``'s initial weights and moments. Tolerance:
the port's uninterrupted losses are within 1e-5 relative of JAX's (f32 on
both, sums in another order, the port's flash plain version against JAX's
plain attention); every resumed run is held to the port's own
uninterrupted losses BITWISE. For each of the 8 crash points the port's
``steps()``/``latest()`` after the crash equal JAX's manager's under the
same saves and the same fault.
"""
import gc
import os
import signal
import threading
import weakref

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.distributed.checkpoint.manager import \
    CheckpointManager as JaxManager
from paddle_tpu.models import llama as jl
from paddle_tpu.testing import faults as jfaults

from paddle_tpu_torch.distributed.checkpoint import save_load as sl
from paddle_tpu_torch.distributed.checkpoint.manager import (
    CRASH_POINTS, MARKER, CheckpointManager, Preempted)
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.observability import FlightRecorder, load_dump
from paddle_tpu_torch.testing import faults

B, S, N_STEPS = 2, 64, 5
KW = dict(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
          seq=128)


@pytest.fixture
def faults_on(monkeypatch):
    monkeypatch.setenv(faults.ENV_FAULTS, "1")
    monkeypatch.setenv(jfaults.ENV_FAULTS, "1")
    yield
    faults.disarm()
    jfaults.disarm()


def _batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(N_STEPS):
        ids = rng.randint(0, 96, size=(B, S + 1)).astype(np.int32)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


@pytest.fixture(scope="module")
def train():
    """(port step fn, the JAX initial state as numpy, JAX's losses, the
    port's uninterrupted losses)."""
    jcfg = jl.llama_tiny(**KW)
    jstep, p, o = jl.build_train_step(
        jcfg, jl.ParallelConfig(remat=False, use_flash=False))
    init = jax.tree_util.tree_map(np.asarray, {"params": p, "opt": o})
    jlosses = []
    for ids, labels in _batches():
        p, o, loss = jstep(p, o, ids, labels)
        jlosses.append(float(loss))
    tstep, _, _ = tl.build_train_step(tl.llama_tiny(**KW),
                                      tl.ParallelConfig(remat=False),
                                      device="cpu")
    ctx = {"step": tstep, "init": init}
    ref = _train(ctx, _state(ctx), None, 0, N_STEPS)
    np.testing.assert_allclose(ref, jlosses, rtol=1e-5)
    ctx["ref"] = ref
    return ctx


def _state(ctx, seed=None):
    """A fresh train state: the shared initial one, or (seed) the port's
    own init from another seed, as a restarted process would build."""
    if seed is None:
        return {**tl.params_from_numpy(ctx["init"], "cpu"), "step": 0}
    params = tl.init_llama_params(tl.llama_tiny(**KW), seed, device="cpu")
    return {"params": params, "opt": tl._adamw_init(params), "step": 0}


def _train(ctx, state, mgr, start, stop, recorder=None):
    batches, losses = _batches(), []
    for i in range(start, stop):
        ids, labels = batches[i]
        state["params"], state["opt"], loss = ctx["step"](
            state["params"], state["opt"], ids, labels)
        losses.append(float(loss))
        state["step"] = i + 1
        if mgr is not None:
            mgr.on_step(i + 1, lambda: state, recorder)
    return losses


def _jax_crash(ctx, root, point):
    """JAX's manager under the same saves (steps 1 and 2, then 3 with the
    fault armed at `point`): its (steps(), latest())."""
    jm = JaxManager(root, keep=8, interval=1)
    state = {**jax.tree_util.tree_map(np.asarray, ctx["init"])}
    for s in (1, 2):
        jm.save(dict(state, step=s), s)
    assert jm.wait() == []
    with jfaults.scope(point, "raise") as plan:
        jm.save(dict(state, step=3), 3)
        errs = jm.wait()
    assert plan.fired == 1 and len(errs) == 1
    return jm.steps(), jm.latest()


# -- the crash matrix --------------------------------------------------------

@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_matrix_matches_jax_and_resumes_bitwise(point, tmp_path, train,
                                                      faults_on):
    """Kill the step-3 save at `point`: latest() resolves what JAX's does,
    a complete checkpoint, and the resumed losses equal the uninterrupted
    run's exactly."""
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, keep=8, interval=1)
    state = _state(train)
    losses = _train(train, state, mgr, 0, 2)
    assert mgr.wait() == [] and mgr.latest() == 2
    with faults.scope(point, "raise") as plan:
        losses += _train(train, state, mgr, 2, 3)
        errs = mgr.wait()
    assert plan.fired == 1, f"{point} was never reached"
    # the injected crash surfaced as that save's error, not a training
    # failure: the loss stream is untouched
    assert len(errs) == 1 and isinstance(errs[0][1], faults.FaultError)
    assert losses == train["ref"][:3]
    expect = 3 if point == "ckpt.commit.after_marker" else 2
    assert (mgr.steps(), mgr.latest()) == \
        _jax_crash(train, str(tmp_path / "jax"), point) == \
        (list(range(1, expect + 1)), expect)
    assert mgr.verify_step(expect)

    # "restart": a fresh process discovers the root from disk alone
    state2 = _state(train, seed=1)
    start = CheckpointManager(root).restore(state2)
    assert start == expect and int(state2["step"]) == expect
    assert _train(train, state2, None, start, N_STEPS) == train["ref"][start:]


def test_corrupted_checkpoint_falls_back_older(tmp_path, train):
    """Bitrot in a committed checkpoint: restore detects the checksum
    mismatch, warns, and resumes from the next-older step, bitwise."""
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=8, interval=1)
    _train(train, _state(train), mgr, 0, 3)
    assert mgr.wait() == [] and mgr.latest() == 3
    victim = faults.corrupt_array_file({"dir": mgr.step_dir(3)})
    assert victim.startswith(os.path.join(mgr.step_dir(3), "arrays"))
    assert not mgr.verify_step(3) and mgr.verify_step(2)
    state2 = _state(train, seed=1)
    with pytest.warns(RuntimeWarning, match="checksum"):
        start = CheckpointManager(str(tmp_path / "ck")).restore(state2)
    assert start == 2
    assert _train(train, state2, None, 2, N_STEPS) == train["ref"][2:]


# -- rolling window / completeness ------------------------------------------

def test_rolling_keep_n_gc_like_jax(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    jm = JaxManager(str(tmp_path / "jax"), keep=2)
    for s in (1, 2, 3, 4):
        w = np.full(8, float(s), np.float32)
        mgr.save({"w": torch.from_numpy(w), "step": s}, s, block=True)
        jm.save({"w": w, "step": s}, s, block=True)
    assert mgr.steps() == jm.steps() == [3, 4]
    assert not os.path.isdir(mgr.step_dir(1))
    assert not os.path.isdir(mgr.step_dir(2))
    tgt = {"w": torch.zeros(8), "step": 0}
    assert mgr.restore(tgt) == 4
    assert torch.equal(tgt["w"], torch.full((8,), 4.0))


def test_latest_skips_incomplete_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=4)
    mgr.save({"w": torch.arange(4, dtype=torch.float32), "step": 1}, 1,
             block=True)
    # a killed save's residue: dir without a marker ...
    os.makedirs(os.path.join(mgr.root, "step_00000002"))
    # ... and one whose marker is torn mid-write
    d3 = os.path.join(mgr.root, "step_00000003")
    os.makedirs(d3)
    with open(os.path.join(d3, MARKER), "w") as f:
        f.write("{not json")
    assert mgr.latest() == 1
    tgt = {"w": torch.zeros(4), "step": 0}
    assert mgr.restore(tgt) == 1
    assert torch.equal(tgt["w"], torch.arange(4, dtype=torch.float32))


def test_on_step_interval_pacing(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=8, interval=2)
    state_fn = lambda: {"w": torch.ones(4)}  # noqa: E731
    saved = [mgr.on_step(s, state_fn) is not None for s in range(1, 6)]
    assert mgr.wait() == []
    assert saved == [False, True, False, True, False]
    assert mgr.steps() == [2, 4]


def test_knobs_supply_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_CKPT_KEEP", "5")
    monkeypatch.setenv("PADDLE_TPU_TORCH_CKPT_INTERVAL", "auto")
    monkeypatch.setenv("PADDLE_TPU_TORCH_PREEMPT_GRACE", "2.5")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert (mgr.keep, mgr.interval, mgr.grace) == (5, None, 2.5)
    monkeypatch.setenv("PADDLE_TPU_TORCH_CKPT_INTERVAL", "3")
    assert CheckpointManager(str(tmp_path / "ck")).interval == 3
    # explicit arguments out-rank the environment
    m2 = CheckpointManager(str(tmp_path / "ck"), keep=1, interval=7,
                           grace=1.0)
    assert (m2.keep, m2.interval, m2.grace) == (1, 7, 1.0)


def test_restore_on_empty_root_names_the_reason(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError, match="empty"):
        mgr.restore({"w": torch.zeros(2)})


# -- concurrency edges -------------------------------------------------------

def test_wait_on_unstarted_handle():
    h = sl.AsyncSaveHandle(threading.Thread(target=lambda: None))
    assert not h.started() and not h.done()
    with pytest.raises(RuntimeError, match="never started"):
        h.wait()


def test_failed_handle_error_is_sticky(tmp_path, faults_on):
    sd = {"w": torch.ones(2)}
    path = str(tmp_path / "ck")
    with faults.scope("ckpt.write.begin", "raise"):
        h = sl.save_state_dict(sd, path, async_save=True)
        with pytest.raises(faults.FaultError):
            h.wait()
    assert h.started() and h.done()
    with pytest.raises(faults.FaultError):
        h.wait()  # every waiter sees the failure, not just the first
    # the dead save deregistered itself: the path is reusable
    sl.save_state_dict(sd, path)
    tgt = {"w": torch.zeros(2)}
    sl.load_state_dict(tgt, path)
    assert torch.equal(tgt["w"], torch.ones(2))


def test_two_managers_one_directory(tmp_path):
    root = str(tmp_path / "shared")
    m1 = CheckpointManager(root, keep=2)
    m2 = CheckpointManager(root, keep=2)
    st = {"w": torch.ones(4)}
    m1.save(st, 1)
    m2.save(st, 2)
    assert m1.wait() == [] and m2.wait() == []
    assert m1.steps() == m2.steps() == [1, 2]
    # either manager may roll the shared window; completeness, not
    # ownership, decides what is reapable
    m2.keep = 1
    m2.gc()
    assert m1.steps() == [2]
    # re-saving a published step (same or different manager) replaces it
    m1.save(st, 3, block=True)
    m2.save(st, 3, block=True)
    assert m1.latest() == 3 and m1.verify_step(3)


def test_gc_never_reaps_in_flight_write(tmp_path, faults_on):
    """keep-N sweeps racing an in-flight async write: the half-written dir
    is invisible to steps() and untouched by gc()."""
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=1)
    st = {"w": torch.zeros(2048)}
    mgr.save(st, 1, block=True)
    assert mgr.steps() == [1]
    with faults.scope("ckpt.write.after_arrays", "delay", delay_s=0.4):
        mgr.save(st, 2)  # writer parked mid-protocol for 0.4 s
        for _ in range(3):
            mgr.gc()  # racing sweeps during the window
        assert mgr.steps() == [1]  # the in-flight dir is no checkpoint yet
        assert mgr.wait() == []
    # once complete, the window rolls: 2 in, 1 out
    assert mgr.steps() == [2]
    assert mgr.verify_step(2)


@pytest.mark.parametrize("point", [None, "ckpt.write.after_arrays",
                                   "ckpt.commit.before_marker"])
def test_a_finished_save_releases_its_snapshot(point, tmp_path, monkeypatch,
                                               faults_on):
    """The host copy of the state lives only while the write runs: a save
    that ends, or fails with its error kept by the manager (whose
    traceback holds the writer's frames), holds no snapshot after."""
    made = []
    real = sl._snapshot

    def spy(v):
        snap = real(v)
        made.append(weakref.ref(snap.array))
        return snap
    monkeypatch.setattr(sl, "_snapshot", spy)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    st = {"w": torch.ones(1 << 16), "opt": {"m": torch.zeros(1 << 16)}}
    if point is None:
        mgr.save(st, 1)
        assert mgr.wait() == []
    else:
        with faults.scope(point, "raise"):
            mgr.save(st, 1)
            errs = mgr.wait()
        assert len(errs) == 1 and mgr.save_errors == errs
    gc.collect()
    assert len(made) == 2 and all(r() is None for r in made)


# -- preemption --------------------------------------------------------------

def test_sigterm_final_save_dump_and_bitwise_resume(tmp_path, monkeypatch,
                                                    train):
    """SIGTERM mid-run: the pending async save lands, one final sync save
    commits the current step, the flight-recorder ring is dumped, and the
    resumed run matches the uninterrupted losses bitwise."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY_DIR", str(tmp_path / "t"))
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=4, interval=2,
                            grace=30.0)
    rec = FlightRecorder(source="train_step")
    state = _state(train)
    mgr.install_preemption_handler()
    try:
        _train(train, state, mgr, 0, 2, rec)
        os.kill(os.getpid(), signal.SIGTERM)
        with pytest.raises(Preempted) as ei:
            _train(train, state, mgr, 2, 3, rec)
    finally:
        mgr.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) != mgr._on_signal
    assert ei.value.step == 3
    assert ei.value.checkpoint == mgr.step_dir(3)
    assert mgr.latest() == 3 and mgr.verify_step(3)
    assert mgr.steps() == [2, 3]
    assert len(rec.dumped) == 1
    payload = load_dump(rec.dumped[0])
    assert payload["reason"] == "preemption"
    assert payload["source"] == "train_step"

    state2 = _state(train, seed=1)
    assert CheckpointManager(str(tmp_path / "ck")).restore(state2) == 3
    assert _train(train, state2, None, 3, N_STEPS) == train["ref"][3:]


def test_preemption_without_signal_and_a_failed_final_save(tmp_path,
                                                           faults_on):
    """request_preemption() works off the main thread's signals; a final
    save that fails leaves checkpoint None and latest() on the older
    step."""
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=4, interval=1)
    st = {"w": torch.ones(4)}
    mgr.on_step(1, lambda: st)
    assert mgr.wait() == []
    mgr.request_preemption()
    assert mgr.preempted
    with faults.scope("ckpt.write.after_arrays", "raise"):
        with pytest.warns(RuntimeWarning, match="final preemption save"):
            with pytest.raises(Preempted) as ei:
                mgr.on_step(2, lambda: st)
    assert ei.value.step == 2 and ei.value.checkpoint is None
    assert mgr.latest() == 1


# -- save_load satellites ----------------------------------------------------

def test_leaf_checksums_fold_shape_and_dtype():
    a = {"w": np.zeros((2, 4), np.float32)}
    assert sl.leaf_checksums(a) == sl.leaf_checksums(
        {"w": torch.zeros(2, 4)})
    # same bytes, different shape/dtype: must not collide
    assert sl.leaf_checksums(a) != sl.leaf_checksums(
        {"w": np.zeros((4, 2), np.float32)})
    assert sl.leaf_checksums(a) != sl.leaf_checksums(
        {"w": np.zeros((2, 4), np.int32)})
    # bf16 and int16 share their bits but not their name
    assert sl.leaf_checksums({"w": torch.zeros(4, dtype=torch.bfloat16)}) \
        != sl.leaf_checksums({"w": torch.zeros(4, dtype=torch.int16)})
