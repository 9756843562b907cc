"""Port parity: poison-request quarantine of paddle_tpu_torch's engine
against paddle_tpu's, on the traces of tests/test_serving_quarantine.py
(1 layer), and the port's own contract at 2 layers, where the JAX engine
differs on purpose.

A request whose prefill raises a PoisonError or an injected fault, or
whose logits go non-finite (a NaN embedding row for token 95), is failed
with a cause and released, the decode batch re-driven without it. A
failure that is neither (a CUDA error on the card, a fault with no
request attribution in decode) propagates, and run() leaves a leak-free
pool.

At 2 layers a poisoned chunk leaves NaN in its freed blocks and in null
block 0 (its padding columns); the JAX engine then sees non-finite logits
for the next requests on reused blocks and quarantines them too, the
port's dead-column repair keeps them clean
(tests/test_torch_dead_columns.py).
"""
import numpy as np
import pytest

from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import (InferenceEngine, PoisonError,
                                        Request, ServeConfig)
from paddle_tpu_torch.testing import faults

from torch_serve_common import (assert_same_run, poisoned, run_jax,
                                run_port, streams, tiny_model)

SERVE = dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
             max_seq_len=256)


@pytest.fixture(autouse=True)
def _faults(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "1")
    monkeypatch.setenv("PADDLE_TPU_TORCH_FAULTS", "1")
    from paddle_tpu.testing import faults as jfaults
    with _common.interpret_mode(True):
        yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def nan_model(model):
    return poisoned(model)


def _prompts(n, size=24, seed=0, hi=95):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, hi, size=size).tolist() for _ in range(n)]


def _both_under(model, point, action, trace, **plan):
    """The trace through both engines, the same fault armed on each."""
    from paddle_tpu.testing import faults as jfaults
    with jfaults.scope(point, action, **plan):
        jeng = run_jax(model, SERVE, trace)
    with faults.scope(point, action, **plan):
        teng = run_port(model, SERVE, trace)
    return jeng, teng


def test_prefill_exception_quarantines_one_request(model):
    p_bad, p_ok = _prompts(2)
    trace = [dict(prompt=p_bad, max_new_tokens=4),
             dict(prompt=p_ok, max_new_tokens=4)]
    jeng, teng = _both_under(model, "serve.prefill.poison", "raise", trace,
                             nth=1)
    assert_same_run(teng, jeng)
    assert teng.failed[0].fail_cause == jeng.failed[0].fail_cause
    assert "prefill" in teng.failed[0].fail_cause


def test_prefill_nan_logits_quarantined(nan_model):
    p_bad = _prompts(1, seed=1)[0]
    p_bad[10] = 95
    p_ok = _prompts(1, seed=2)[0]
    trace = [dict(prompt=p_bad, max_new_tokens=4),
             dict(prompt=p_ok, max_new_tokens=4)]
    jeng = run_jax(nan_model, SERVE, trace)
    teng = run_port(nan_model, SERVE, trace)
    assert_same_run(teng, jeng)
    assert teng.failed[0].fail_cause == "non-finite prefill logits"


def test_injected_logits_corruption_is_screened_on_the_device(model):
    """A corrupting action at serve.prefill.logits writes into the DEVICE
    logits tensor before the screen: the request is quarantined. A
    corrupt plan names its own callable (there is no default corruptor)."""
    with pytest.raises(ValueError, match="corrupt= callable"):
        faults.arm("serve.prefill.logits", "corrupt")
    seen = []

    def corrupt(ctx):
        seen.append(type(ctx["logits"]).__name__)
        ctx["logits"][..., 3] = float("nan")

    p_bad, p_ok = _prompts(2, seed=7)
    with faults.scope("serve.prefill.logits", "corrupt", nth=1,
                      corrupt=corrupt):
        teng = run_port(model, SERVE, [dict(prompt=p_bad, max_new_tokens=3),
                                       dict(prompt=p_ok, max_new_tokens=3)])
    assert seen == ["Tensor"]
    assert [s.fail_cause for s in teng.failed] == ["non-finite prefill logits"]
    assert len(teng.finished) == 1 and teng.pool.used_blocks == 0


def test_nan_check_can_be_disabled(nan_model, monkeypatch):
    _, _, tcfg, tparams = nan_model
    p_bad = _prompts(1, seed=1)[0]
    p_bad[10] = 95
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE,
                                                     nan_check=False),
                          device="cpu")
    stats = eng.run([Request(p_bad, max_new_tokens=2)], deterministic=True)
    assert stats["failed"] == 0 and stats["requests"] == 1
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_NAN_CHECK", "0")
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE), device="cpu")
    assert eng._nan_check is False


def test_decode_nan_row_quarantined_batchmate_survives(nan_model):
    """One decoder's history is forced to the NaN token: only its row is
    quarantined, its batchmate's stream equals a solo run."""
    _, _, tcfg, tparams = nan_model
    p_bad, p_ok = _prompts(2, seed=3)
    solo = run_port(nan_model, SERVE, [dict(prompt=p_ok, max_new_tokens=6)])
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE),
                          record_events=True, device="cpu")
    assert eng.submit(Request(p_bad, max_new_tokens=6)).accepted
    assert eng.submit(Request(p_ok, max_new_tokens=6)).accepted
    while len(eng.active) < 2 or not all(s.generated for s in eng.active):
        eng.step()
    next(s for s in eng.active if s.req.request_id == 0).tokens[-1] = 95
    stats = eng.run([], deterministic=True)
    assert stats["failed"] == 1
    assert eng.failed[0].fail_cause == "non-finite decode logits"
    assert eng.finished[0].tokens == solo.finished[0].tokens
    assert eng.pool.used_blocks == 0


def test_decode_poison_error_redrives_batch(model):
    def boom(ctx):
        raise PoisonError(ctx["rids"][0], "injected decode poison")

    from paddle_tpu.inference import PoisonError as JaxPoisonError

    def jboom(ctx):
        raise JaxPoisonError(ctx["rids"][0], "injected decode poison")

    p_bad, p_ok = _prompts(2, seed=4)
    trace = [dict(prompt=p_bad, max_new_tokens=6),
             dict(prompt=p_ok, max_new_tokens=6)]
    from paddle_tpu.testing import faults as jfaults
    with jfaults.scope("serve.decode.poison", "corrupt", nth=2,
                       corrupt=jboom):
        jeng = run_jax(model, SERVE, trace)
    with faults.scope("serve.decode.poison", "corrupt", nth=2,
                      corrupt=boom):
        teng = run_port(model, SERVE, trace)
    assert_same_run(teng, jeng)
    assert teng.stats()["decode_redrives"] >= 1
    assert teng.failed[0].fail_cause == "injected decode poison"


def test_unattributed_decode_failure_still_raises(model):
    """A decode failure with no request attribution is not quarantined:
    it propagates and the crash path releases every live block."""
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE), device="cpu")
    with faults.scope("serve.decode.poison", "raise", nth=2):
        with pytest.raises(faults.FaultError):
            eng.run([Request(p, max_new_tokens=6)
                     for p in _prompts(2, seed=5)], deterministic=True)
    assert eng.pool.used_blocks == 0
    assert not eng.active and eng.waiting


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_a_launch_error_is_never_quarantined(model, monkeypatch, where):
    """An exception from the device step that is neither a PoisonError nor
    an injected fault (what a failed CUDA launch or sync raises) is never
    turned into a quarantine: it propagates, the pool stays leak-free."""
    import paddle_tpu_torch.inference.engine as emod
    _, _, tcfg, tparams = model
    real = getattr(emod, f"llama_paged_{where}_" +
                   ("chunk" if where == "prefill" else "step"))
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if where == "prefill" or len(calls) > 1:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(*a, **k)

    monkeypatch.setattr(emod, real.__name__, failing)
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.run([Request(p, max_new_tokens=4)
                 for p in _prompts(2, seed=8)], deterministic=True)
    assert not eng.failed
    assert eng.pool.used_blocks == 0 and not eng.active


def test_quarantine_reaches_observability(model):
    p_bad, p_ok = _prompts(2, seed=6)
    trace = [dict(prompt=p_bad, max_new_tokens=3),
             dict(prompt=p_ok, max_new_tokens=3)]
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**SERVE),
                          record_events=True, trace_requests=True,
                          flight_recorder=True, device="cpu")
    with faults.scope("serve.prefill.poison", "raise", nth=1):
        eng.run([Request(**r) for r in trace], deterministic=True)
    assert eng.tracer.span_count("quarantine") == 1
    assert any(r.get("event") == "quarantine" and r.get("rid") == 0
               for r in eng.recorder.ring)
    assert "paddle_tpu_serve_failed_requests 1" in eng.render_prometheus()


def test_two_layer_poison_does_not_spread(monkeypatch):
    """At 2 layers, 8 requests through 2 rows with the poisoned one first:
    it fails with 'non-finite prefill logits' and EVERY other request
    finishes, on blocks the poisoned one freed, with the streams of a run
    that never held it. The JAX engine quarantines more (a deviation the
    port makes on purpose)."""
    model2 = poisoned(tiny_model(layers=2, seed=5))
    prompts = _prompts(8, size=40, seed=9)
    # 24 live tokens of a 32-token chunk: from layer 1 on its padding
    # columns, written to null block 0, hold NaN
    prompts[0] = prompts[0][:24]
    prompts[0][10] = 95
    trace = [dict(prompt=p, max_new_tokens=5, arrival=float(i))
             for i, p in enumerate(prompts)]
    serve = dict(SERVE, num_blocks=4)
    teng = run_port(model2, serve, trace)
    assert [(s.req.request_id, s.fail_cause) for s in teng.failed] == \
        [(0, "non-finite prefill logits")]
    assert len(teng.finished) == 7 and teng.pool.used_blocks == 0
    clean = run_port(model2, serve, [dict(r, request_id=i)
                                     for i, r in enumerate(trace) if i])
    assert streams(teng) == streams(clean)
    jeng = run_jax(model2, serve, trace)
    assert len(jeng.failed) > 1, "the JAX engine's NaN spreads"
