"""Port parity: overload-hardened serving (admission control, deadlines and
load shedding, graceful degradation) of paddle_tpu_torch's engine against
paddle_tpu's, on the traces of tests/test_serving_overload.py.

The admission valves are host-side and checked without device work; the
2x-capacity deterministic burst runs through both engines once (module
fixtures) and must give the same shed list, streams, events, outcomes
and stats(); the knobs are set under their ``PADDLE_TPU_TORCH_`` names.
"""
import numpy as np
import pytest

from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import (Admission, BlockPool,
                                        BlockPoolError, InferenceEngine,
                                        Request, ServeConfig)

from torch_serve_common import (assert_same_run, run_jax, run_port,
                                tiny_model)


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _engine(model, **kw):
    _, _, tcfg, tparams = model
    return InferenceEngine(tparams, tcfg, ServeConfig(**kw), device="cpu")


def _prompts(n, size=20, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 96, size=size).tolist() for _ in range(n)]


def test_bounded_queue_rejects_with_cause(model):
    eng = _engine(model, block_size=128, num_blocks=10, max_batch=2,
                  max_seq_len=256, max_queue=2)
    outs = [eng.submit(Request(p, max_new_tokens=4)) for p in _prompts(4)]
    assert all(isinstance(o, Admission) for o in outs)
    assert [o.cause for o in outs] == [None, None, "queue_full",
                                       "queue_full"]
    assert len(eng.waiting) == 2 and len(eng.rejected) == 2
    assert eng.outcomes()[outs[2].request_id] == ("rejected", "queue_full")


def test_overcommit_and_rate_limit(model):
    eng = _engine(model, block_size=128, num_blocks=4, max_batch=2,
                  max_seq_len=384, overcommit=1.0, max_queue=16)
    a = eng.submit(Request([1] * 200, max_new_tokens=4))   # 2 blocks
    b = eng.submit(Request([1] * 100, max_new_tokens=4))   # 1 block
    c = eng.submit(Request([1] * 10, max_new_tokens=4))    # over budget
    assert a.accepted and b.accepted
    assert (c.accepted, c.cause) == (False, "overcommit")
    eng = _engine(model, block_size=128, num_blocks=16, max_batch=2,
                  max_seq_len=256, rate_limit=0.5, burst=2, max_queue=64)
    burst = [eng.submit(Request(p, max_new_tokens=2))
             for p in _prompts(3, size=8)]
    assert [o.cause for o in burst] == [None, None, "rate_limit"]
    eng._clock = 2.0                   # one refill at rate 0.5
    again = [eng.submit(Request(p, max_new_tokens=2))
             for p in _prompts(2, size=8, seed=1)]
    assert [o.accepted for o in again] == [True, False]


@pytest.mark.parametrize("name,value,attr,want", [
    ("PADDLE_TPU_TORCH_SERVE_MAX_QUEUE", "1", "max_queue", 1),
    ("PADDLE_TPU_TORCH_SERVE_OVERCOMMIT", "2.5", "overcommit", 2.5),
])
def test_env_knobs_drive_admission(model, monkeypatch, name, value, attr,
                                   want):
    base = dict(block_size=128, num_blocks=10, max_batch=2, max_seq_len=256)
    monkeypatch.setenv(name, value)
    assert getattr(_engine(model, **base).admission, attr) == want
    # an explicit ServeConfig field wins over the knob
    assert getattr(_engine(model, **base, **{attr: 7}).admission,
                   attr) == 7
    # the JAX package's own knob does not steer the port
    monkeypatch.delenv(name)
    monkeypatch.setenv(name.replace("TORCH_", ""), value)
    assert getattr(_engine(model, **base).admission, attr) != want


def test_rate_and_burst_knobs(model, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_RATE", "0.25")
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_BURST", "3")
    eng = _engine(model, block_size=128, num_blocks=10, max_batch=2,
                  max_seq_len=256)
    assert eng.admission.bucket.rate == 0.25
    assert eng.admission.bucket.burst == 3.0
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_RATE", "fast")
    with pytest.raises(ValueError, match="PADDLE_TPU_TORCH_SERVE_RATE"):
        _engine(model, block_size=128, num_blocks=10, max_batch=2,
                max_seq_len=256)


def test_malformed_requests_still_raise(model):
    eng = _engine(model, block_size=128, num_blocks=4, max_batch=4,
                  max_seq_len=256)
    with pytest.raises(ValueError):
        eng.submit(Request([1] * 300, max_new_tokens=16))
    with pytest.raises(ValueError):
        eng.submit(Request([]))


OVERLOAD = dict(block_size=128, num_blocks=3, max_batch=1, prefill_chunk=32,
                max_seq_len=256, max_queue=8, overcommit=8.0)


def _overload_trace(seed=0):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(1, 96, size=30).tolist(),
                 max_new_tokens=6, arrival=float(i), ttft_deadline=10.0,
                 deadline=40.0) for i in range(6)]


@pytest.fixture(scope="module")
def overload(model):
    trace = _overload_trace()
    return (run_jax(model, OVERLOAD, trace),
            run_port(model, OVERLOAD, trace),
            run_port(model, OVERLOAD, trace))


def test_overload_replay_matches_jax(overload):
    jeng, teng, _ = overload
    assert teng.shed, "the overload trace must shed"
    assert sorted((s.req.request_id, s.fail_cause) for s in teng.shed) == \
        sorted((s.req.request_id, s.fail_cause) for s in jeng.shed)
    assert_same_run(teng, jeng)


def test_overload_replay_is_deterministic(overload):
    _, a, b = overload
    assert a.events == b.events and a.outcomes() == b.outcomes()
    assert {s.req.request_id: s.tokens for s in a.finished} == \
        {s.req.request_id: s.tokens for s in b.finished}


def test_every_request_ends_with_a_cause(overload):
    _, teng, _ = overload
    out = teng.outcomes()
    assert set(out) == set(range(6))
    for rid, (state, cause) in out.items():
        assert state in ("finished", "shed", "rejected", "failed")
        assert state == "finished" or cause


def test_shed_events_reach_observability(model):
    rng = np.random.RandomState(2)
    trace = [dict(prompt=rng.randint(1, 96, size=30).tolist(),
                  max_new_tokens=6, arrival=float(i), ttft_deadline=6.0)
             for i in range(4)]
    kw = dict(trace_requests=True, flight_recorder=True)
    jeng = run_jax(model, OVERLOAD, trace, **kw)
    teng = run_port(model, OVERLOAD, trace, **kw)
    assert_same_run(teng, jeng)
    shed = {s.req.request_id for s in teng.shed}
    assert shed and teng.tracer.span_count("shed") == len(shed)
    assert {r["rid"] for r in teng.recorder.ring
            if r.get("event") == "shed"} == shed
    assert "paddle_tpu_serve_shed_requests" in teng.render_prometheus()


def test_eviction_is_priority_aware(model):
    eng = _engine(model, block_size=128, num_blocks=6, max_batch=2,
                  prefill_chunk=32, max_seq_len=256)
    rng = np.random.RandomState(3)
    lo = Request(rng.randint(1, 96, size=8).tolist(), max_new_tokens=8)
    hi = Request(rng.randint(1, 96, size=8).tolist(), max_new_tokens=8,
                 priority=5)
    assert eng.submit(lo).accepted and eng.submit(hi).accepted
    while any(s.state != "running" for s in eng.active) \
            or len(eng.active) < 2:
        eng.step()
    assert eng._evict_one()
    assert eng.waiting[0].req.request_id == lo.request_id
    assert all(s.req.request_id == hi.request_id for s in eng.active)


def test_prefill_shrinks_before_evicting(model):
    """Steal most of the pool mid-prefill: the next chunk shrinks its live
    span to the headroom, and the stream matches the JAX engine's."""
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, 96, size=400).tolist()
    serve = dict(block_size=128, num_blocks=7, max_batch=1,
                 prefill_chunk=256, max_seq_len=512)
    eng = _engine(model, **serve)
    eng.record_events = True
    assert eng.submit(Request(prompt, max_new_tokens=4)).accepted
    eng.step()
    assert eng.active[0].n_cached == 256
    stolen = eng.pool.alloc(3)
    eng.step()                       # 144 -> 128
    assert eng.active[0].n_cached == 256 + 128
    eng.pool.free(stolen)
    stats = eng.run([], deterministic=True)
    assert [ev[3] for ev in eng.events if ev[1] == "prefill_shrink"] == [128]
    assert stats["preemptions"] == 0
    assert set(stats["compiles"]) <= {"prefill_256", "decode_1"}
    want = run_jax(model, serve, [dict(prompt=prompt, max_new_tokens=4)])
    assert eng.finished[0].tokens == want.finished[0].tokens
    assert eng.pool.used_blocks == 0


def test_block_pool_named_errors():
    pool = BlockPool(num_blocks=8, block_size=128)
    blocks = pool.alloc(3)
    free_before = pool.free_blocks
    with pytest.raises(BlockPoolError, match="null block 0"):
        pool.free([0])
    with pytest.raises(BlockPoolError, match="out-of-range"):
        pool.free([8])
    pool.free([blocks[0]])
    with pytest.raises(BlockPoolError, match="double free"):
        pool.free([blocks[0]])
    with pytest.raises(BlockPoolError, match="double free"):
        pool.free([blocks[1], blocks[1]])
    assert pool.free_blocks == free_before + 1
    pool.free(blocks[1:])
    assert pool.used_blocks == 0 and issubclass(BlockPoolError, ValueError)
