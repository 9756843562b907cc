"""The port's serving operations against paddle_tpu's engine
(tests/test_weight_swap.py's traces and the engine's surface): live weight
swap (from a tree, a checkpoint directory or a CheckpointManager root),
preemption, drain/undrain, adoption of migrated requests, the load
signal, and the piece the port leaves out on purpose (tensor-parallel
serving), which raises naming its ROADMAP item.

The port's ``swap_weights`` copies each leaf INTO the engine's current
leaf (``copy_``), so the draft model's leaves, views of the base's, follow;
each engine here gets its own copy of the weights.
"""
import os
import signal

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.distributed.checkpoint import save_load as jsl
from paddle_tpu.distributed.checkpoint.manager import \
    CheckpointManager as JaxManager
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServeConfig as JaxServeConfig
from paddle_tpu.ops import _common

from paddle_tpu_torch.distributed.checkpoint import save_load as sl
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.inference import InferenceEngine, Request, ServeConfig
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.testing import faults

from torch_serve_common import run_port, streams, tiny_model

SERVE = dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
             max_seq_len=512)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_FAULTS", "1")
    with _common.interpret_mode(True):
        yield
    faults.disarm()


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def other(model):
    """Different weights of the same shapes (seed 11), as a port tree."""
    return tiny_model(seed=11)[3]


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def _engine(model, serve=None, **kw):
    _, _, tcfg, tparams = model
    return InferenceEngine(_clone(tparams), tcfg,
                           ServeConfig(**(serve or SERVE)),
                           record_events=True, device="cpu", **kw)


def _trace(arrivals=(0.0, 1.0), new=5):
    rng = np.random.RandomState(0)
    return [dict(prompt=rng.randint(1, 96, size=n).tolist(),
                 max_new_tokens=new, arrival=a)
            for n, a in zip((7, 130), arrivals)]


def test_mid_serve_identical_swap_is_bit_identical(model):
    base = run_port(model, SERVE, _trace())
    eng = _engine(model)
    assert eng.swap_weights(_clone(model[3]), at_iteration=3) == \
        {"scheduled_at": 3}
    stats = eng.run([Request(**r) for r in _trace()], deterministic=True)
    assert streams(eng) == streams(base)
    assert stats["weight_swaps"] == 1 and stats["unfinished"] == 0
    assert eng.last_swap["iteration"] == 2
    assert eng.last_swap["n_leaves"] == len(list(tl._leaves(eng.params)))
    assert (eng.last_swap["in_flight_running"]
            + eng.last_swap["in_flight_prefill"]) >= 1
    assert eng.pool.used_blocks == 0
    assert [e for e in eng.events if "swap" in e[1]] == \
        [(0, "swap_scheduled", 3), (2, "swap", eng.last_swap["n_leaves"])]


def test_requests_after_swap_follow_new_weights(model, other):
    prompt = _trace()[0]["prompt"]
    old = run_port(model, SERVE, [dict(prompt=prompt, max_new_tokens=4)])
    _, _, tcfg, _ = model
    new = InferenceEngine(_clone(other), tcfg, ServeConfig(**SERVE),
                          device="cpu")
    new.run([Request(prompt, max_new_tokens=4)], deterministic=True)
    assert old.finished[0].generated != new.finished[0].generated
    eng = _engine(model)
    # a numpy tree works as a source too
    eng.swap_weights({k: ({kk: vv.numpy() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.numpy())
                      for k, v in other.items()}, at_iteration=6)
    eng.run([Request(prompt, max_new_tokens=4, arrival=0.0),
             Request(prompt, max_new_tokens=4, arrival=8.0)],
            deterministic=True)
    got = {s.req.request_id: s.generated for s in eng.finished}
    assert got[0] == old.finished[0].generated
    assert got[1] == new.finished[0].generated


def test_swap_keeps_the_draft_model_in_step(model, other):
    """The default draft shares the base's leaves by view: after a swap in
    place it drafts from the new weights, and the streams equal an engine
    built on them."""
    _, _, tcfg, _ = model
    serve = dict(SERVE, speculative=True, draft_k=3)
    eng = _engine(model, serve)
    eng.swap_weights(_clone(other))
    assert torch.equal(eng.draft_params["layers"]["q_proj"][0],
                       other["layers"]["q_proj"][0])
    eng.run([Request(**r) for r in _trace()], deterministic=True)
    ref = InferenceEngine(_clone(other), tcfg, ServeConfig(**serve),
                          record_events=True, device="cpu")
    ref.run([Request(**r) for r in _trace()], deterministic=True)
    assert streams(eng) == streams(ref)
    assert eng.stats()["speculative"] == ref.stats()["speculative"] | {
        "draft_step_ms_mean": eng.stats()["speculative"][
            "draft_step_ms_mean"]}


def test_swap_rejects_mismatches_and_checkpoint_dirs(model, tmp_path):
    eng = _engine(model)
    bad = _clone(model[3])
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.swap_weights(bad)
    missing = _clone(model[3])
    del missing["final_norm"]
    with pytest.raises(ValueError, match="tree mismatch"):
        eng.swap_weights(missing)
    # a checkpoint directory is checked as a tree is: a saved leaf of
    # another shape, a manager root with no complete step, no checkpoint
    sl.save_state_dict(bad, str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.swap_weights(str(tmp_path / "bad"))
    os.makedirs(tmp_path / "root" / "step_00000001")
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        eng.swap_weights(tmp_path / "root")
    with pytest.raises(FileNotFoundError):
        eng.swap_weights(str(tmp_path / "nothing"))
    assert eng.swaps == 0 and eng._pending_swap is None


def test_swap_from_checkpoint_dir_and_manager_root(model, tmp_path):
    """tests/test_weight_swap.py's case on both sides: a save_state_dict
    dir of other weights, then a manager root whose newest checkpoint
    nests them under a train state's "params" (deferred to an iteration
    boundary on the port); the streams follow the new weights."""
    jcfg, jparams, tcfg, tparams = model
    j2, t2 = tiny_model(seed=11)[1], tiny_model(seed=11)[3]
    prompt = _trace()[0]["prompt"]
    jserve = JaxServeConfig(**SERVE)

    def jax_run(source):
        with _common.interpret_mode(True):
            # a tree of new dicts: JAX's swap rebinds leaves in place
            eng = JaxEngine(jax.tree_util.tree_map(lambda a: a, jparams),
                            jcfg, jserve)
            stats = eng.swap_weights(source)
            eng.run([JaxRequest(prompt, max_new_tokens=4, arrival=0.0)],
                    deterministic=True)
        return stats, eng.finished[0].generated

    jsl.save_state_dict(j2, str(tmp_path / "jck"))
    jm = JaxManager(str(tmp_path / "jroot"), keep=2)
    jm.save({"params": jparams, "step": 1}, 1, block=True)
    jm.save({"params": j2, "step": 2}, 2, block=True)
    want = [jax_run(str(tmp_path / "jck")),
            jax_run(str(tmp_path / "jroot"))]

    sl.save_state_dict(_clone(t2), str(tmp_path / "ck"))
    mgr = CheckpointManager(str(tmp_path / "root"), keep=2)
    mgr.save({"params": _clone(tparams), "step": 1}, 1, block=True)
    mgr.save({"params": _clone(t2), "step": 2}, 2, block=True)
    for i, (source, want_src) in enumerate((
            (str(tmp_path / "ck"), os.path.abspath(tmp_path / "ck")),
            (tmp_path / "root", mgr.step_dir(2)))):
        eng = _engine(model)
        if i == 0:
            stats = eng.swap_weights(source)
        else:
            assert eng.swap_weights(source, at_iteration=1) == \
                {"scheduled_at": 1}
        eng.run([Request(prompt, max_new_tokens=4, arrival=1.0)],
                deterministic=True)
        stats = eng.last_swap
        jstats, jtokens = want[i]
        assert stats["source"] == want_src
        assert stats["n_leaves"] == jstats["n_leaves"] == \
            len(list(tl._leaves(tparams)))
        assert eng.finished[0].generated == jtokens
        assert torch.equal(eng.params["embed"], t2["embed"])
    assert want[0][1] != run_port(model, SERVE, [dict(
        prompt=prompt, max_new_tokens=4)]).finished[0].generated


def test_tensor_parallel_serving_is_refused(model):
    """Without a process group of mp ranks: tensor-parallel serving is
    ported (tests/test_torch_serving_tp.py), and an engine with nothing
    to shard over refuses by name."""
    assert ServeConfig(mp=2).mp == 2 and ServeConfig(mp=1).mp == 1
    with pytest.raises(ValueError, match="needs a process group of 2"):
        _engine(model, dict(SERVE, mp=2))


def test_swap_under_preemption_storm_drops_nothing(model):
    rng = np.random.RandomState(1)
    trace = [dict(prompt=rng.randint(1, 96, size=120).tolist(),
                  max_new_tokens=16, arrival=float(i)) for i in range(3)]
    serve = dict(block_size=128, num_blocks=5, max_batch=3,
                 prefill_chunk=64, max_seq_len=256)
    ref = run_port(model, serve, trace)
    eng = _engine(model, serve)
    eng.swap_weights(_clone(model[3]), at_iteration=6)
    with faults.scope("serve.preempt_storm", "fire", p=0.25, seed=5,
                      max_fires=None) as plan:
        stats = eng.run([Request(**r) for r in trace], deterministic=True)
    assert plan.fired >= 1 and stats["preemptions"] >= 1
    assert stats["requests"] == 3 and eng.swaps == 1
    assert {s.req.request_id: s.generated for s in eng.finished} == \
        {s.req.request_id: s.generated for s in ref.finished}
    assert eng.pool.used_blocks == 0


def test_injected_preemption_stops_cleanly_and_resumes(model, tmp_path,
                                                       monkeypatch):
    from paddle_tpu_torch.observability import load_dump
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY_DIR", str(tmp_path))
    base = run_port(model, SERVE, _trace())
    eng = _engine(model, flight_recorder=True)
    with faults.scope("serve.preempt", "fire", nth=3):
        st1 = eng.run([Request(**r) for r in _trace()], deterministic=True)
    assert st1["preempted"] is True and st1["unfinished"] >= 1
    assert any(e[1] == "preempt_stop" for e in eng.events)
    assert load_dump(eng.recorder.dumped[0])["reason"] == "preemption"
    eng.run([], deterministic=True)
    assert streams(eng) == streams(base) and eng.pool.used_blocks == 0


def test_sigterm_preempts_then_cleared_engine_serves(model):
    base = run_port(model, SERVE, _trace((0.0, 0.0)))
    eng = _engine(model)
    reqs = [Request(**r) for r in _trace((0.0, 0.0))]
    eng.install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        stats = eng.run(reqs, deterministic=True)
    finally:
        eng.uninstall_preemption_handler()
    assert stats["preempted"] is True and not eng.finished
    eng.clear_preemption()
    eng.run(reqs, deterministic=True)
    assert streams(eng) == streams(base)


def test_drain_undrain_adopt_and_load_signal(model):
    """drain() rejects new work with cause 'draining' and runs the rest to
    completion (the same outcomes as JAX's); undrain() reopens; adopt()
    takes a migrated request with its emitted tokens past the valves and
    finishes it with the donor's stream."""
    jcfg, params, _, _ = model
    trace = _trace()
    outs = []
    for make, req in ((lambda: _engine(model), Request),
                      (lambda: JaxEngine(params, jcfg, _jax_serve(),
                                         record_events=True), _jax_request)):
        eng = make()
        assert eng.load_signal() == (0.0, -9.0, 0.0)
        eng.submit(req(**trace[0]))
        eng.step()
        sig = eng.load_signal()
        out = eng.drain(deterministic=True)
        late = eng.submit(req(**trace[1]))
        eng.undrain()
        again = eng.submit(req(**trace[1]))
        eng.run([], deterministic=True)
        outs.append((sig, out, (late.accepted, late.cause), again.accepted,
                     eng.outcomes(), eng.events, streams(eng)))
    assert outs[0] == outs[1]
    assert outs[0][2] == (False, "draining")
    donor = run_port(model, SERVE, trace)
    full = donor.finished[1].generated
    eng = _engine(model)
    eng.adopt(Request(trace[1]["prompt"], max_new_tokens=5, request_id=7),
              generated=full[:2])
    eng.adopt(Request(trace[0]["prompt"], max_new_tokens=5, request_id=8),
              generated=donor.finished[0].generated)   # already complete
    eng.run([], deterministic=True)
    got = {s.req.request_id: s.generated for s in eng.finished}
    assert got == {7: full, 8: donor.finished[0].generated}
    assert eng.stats()["recovered"] == 2 and eng.pool.used_blocks == 0


def _jax_serve():
    from paddle_tpu.inference import ServeConfig as JaxServeConfig
    return JaxServeConfig(**SERVE)


def _jax_request(**kw):
    from paddle_tpu.inference import Request as JaxRequest
    return JaxRequest(**kw)


@pytest.mark.parametrize("name,value,attr,want", [
    ("PADDLE_TPU_TORCH_SERVE_KV_DTYPE", "int8", "kv_dtype", "int8"),
    ("PADDLE_TPU_TORCH_SERVE_SPEC", "1", "speculative", True),
    ("PADDLE_TPU_TORCH_SERVE_SPEC_K", "3", "draft_k", 3),
])
def test_capacity_knobs(model, monkeypatch, name, value, attr, want):
    """ServeConfig's speculative/draft_k/kv_dtype default to None and
    resolve through the knobs to the same defaults as before."""
    eng = _engine(model)
    assert (eng.kv_dtype, eng.speculative, eng.draft_k) == ("auto", False, 4)
    monkeypatch.setenv(name, value)
    assert getattr(_engine(model), attr) == want
    monkeypatch.setenv(name, "junk")
    with pytest.raises(ValueError, match=name):
        _engine(model)


def test_engine_has_every_reference_method():
    """Every method of the JAX engine but ``_step_fn``, its jitted step
    family's dispatch (the port's steps take ``tp=``)."""
    import inspect
    fns = lambda cls: {n for n, v in vars(cls).items()
                       if inspect.isfunction(v)}
    assert fns(JaxEngine) - fns(InferenceEngine) == {"_step_fn"}
