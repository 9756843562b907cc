"""Port parity: the crash-recoverable engine journal of paddle_tpu_torch
against paddle_tpu's (tests/test_engine_journal.py's traces).

A clean run's journal equals the JAX engine's line by line. The crash
matrix arms a ``raise`` at every serve.* crash point, kills the engine
mid-run (a leak-free pool after), recovers into a fresh engine and holds
every stream to the port's uncrashed run, which equals the JAX engine's.
This file runs the plain matrix; test_torch_journal_matrix.py the prefix
cache + int8 and speculation + int8 ones and cross-config recovery.
"""
import numpy as np
import pytest

from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import (EngineJournal, InferenceEngine,
                                        Request, ServeConfig, read_journal)
from paddle_tpu_torch.testing import faults

from torch_serve_common import run_jax, streams, tiny_model

SERVE = dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
             max_seq_len=256)

MATRIX = [
    ("serve.admit.before", 2),   # 2nd submit dies pre-journal
    ("serve.admit.after", 2),    # 2nd submit dies post-journal
    ("serve.prefill.before", 2),
    ("serve.prefill.after", 2),
    ("serve.decode.before", 3),
    ("serve.decode.after", 3),
    ("serve.swap.before", 1),
    ("serve.swap.after", 1),
]


@pytest.fixture(autouse=True)
def _faults(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_FAULTS", "1")
    with _common.interpret_mode(True):
        yield
    faults.disarm()


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def requests(n=3, size=24, max_new=6, seed=0):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(1, 96, size=size).tolist(),
                 max_new_tokens=max_new, arrival=float(i), request_id=i)
            for i in range(n)]


def engine(model, journal, **kw):
    _, _, tcfg, tparams = model
    return InferenceEngine(tparams, tcfg, ServeConfig(**dict(SERVE, **kw)),
                           record_events=True, journal=journal,
                           device="cpu")


def crash_and_recover(model, path, point, nth, trace, **kw):
    """Run ``trace`` into a fault at ``point``, recover a fresh engine
    over the journal, re-submit what was never journaled and finish.
    Returns (streams, the journal read mid-crash)."""
    _, _, _, tparams = model
    eng = engine(model, path, **kw)
    eng.swap_weights(tparams, at_iteration=4)
    with faults.scope(point, "raise", nth=nth) as plan:
        with pytest.raises(faults.FaultError):
            eng.run([Request(**r) for r in trace], deterministic=True)
        assert plan.fired == 1
        assert eng.pool.used_blocks == 0
        mid = read_journal(path)
        eng2 = engine(model, path, **kw)
        assert eng2.recover()["torn_lines"] == 0
        journaled = ({s.req.request_id for s in eng2.waiting}
                     | {s.req.request_id for s in eng2.finished})
        eng2.run([Request(r["prompt"], max_new_tokens=r["max_new_tokens"],
                          request_id=r["request_id"])
                  for r in trace if r["request_id"] not in journaled],
                 deterministic=True)
    assert eng2.pool.used_blocks == 0
    st = read_journal(path)
    assert st.finished == {r["request_id"] for r in trace}
    assert st.torn_lines == 0
    return {s.req.request_id: s.generated for s in eng2.finished}, mid


def uncrashed(model, path, trace, **kw):
    """The uncrashed reference, with the same swap the matrix schedules,
    and the JAX engine's run of it: equal streams and journal lines."""
    _, params, _, tparams = model
    eng = engine(model, path, **kw)
    eng.swap_weights(tparams, at_iteration=4)
    eng.run([Request(**r) for r in trace], deterministic=True)
    jpath = path + ".jax"
    jeng = run_jax(model, dict(SERVE, **kw), [], journal=jpath)
    jeng.swap_weights(params, at_iteration=4)
    from paddle_tpu.inference import Request as JaxRequest
    with _common.interpret_mode(True):
        jeng.run([JaxRequest(**r) for r in trace], deterministic=True)
    assert streams(eng) == streams(jeng)
    assert open(path).read().splitlines() == \
        open(jpath).read().splitlines()
    return {s.req.request_id: s.generated for s in eng.finished}


@pytest.fixture(scope="module")
def plain_ref(model, tmp_path_factory):
    return uncrashed(model, str(tmp_path_factory.mktemp("ref") / "j.jsonl"),
                     requests())


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = EngineJournal(path)
    j.submit(Request([1, 2, 3], max_new_tokens=4, request_id=0,
                     priority=2, ttft_deadline=5.0))
    j.submit(Request([4, 5], max_new_tokens=2, request_id=1))
    j.reject(2, "queue_full")
    j.tokens(1, [(0, 7), (1, 8)])
    j.tokens(2, [(0, 9)])
    j.finish(1)
    j.shed(3, "deadline")
    j.failed(4, "non-finite decode logits")
    j.close()
    with open(path, "a") as f:
        f.write('{"ev": "tokens", "toks": [[0, ')       # a torn write
    st = read_journal(path)
    assert list(st.requests) == [0, 1] and st.requests[0]["priority"] == 2
    assert st.tokens == {0: [7, 9], 1: [8]} and st.finished == {1}
    assert (st.rejected, st.shed) == ({2: "queue_full"}, {3: "deadline"})
    assert st.failed == {4: "non-finite decode logits"}
    assert st.torn_lines == 1 and st.unfinished_rids() == [0]
    # the same calls through the JAX writer give the same bytes
    from paddle_tpu.inference import EngineJournal as JaxJournal
    from paddle_tpu.inference import Request as JaxRequest
    jpath = str(tmp_path / "jax.jsonl")
    jj = JaxJournal(jpath)
    jj.submit(JaxRequest([1, 2, 3], max_new_tokens=4, request_id=0,
                         priority=2, ttft_deadline=5.0))
    jj.submit(JaxRequest([4, 5], max_new_tokens=2, request_id=1))
    jj.reject(2, "queue_full")
    jj.tokens(1, [(0, 7), (1, 8)])
    jj.tokens(2, [(0, 9)])
    jj.finish(1)
    jj.shed(3, "deadline")
    jj.failed(4, "non-finite decode logits")
    jj.close()
    assert open(path).read().startswith(open(jpath).read())


def test_clean_run_journal_equals_jax_and_recovers_idle(model, tmp_path,
                                                        plain_ref):
    path = str(tmp_path / "j.jsonl")
    eng = engine(model, path)
    eng.run([Request(**r) for r in requests(2)], deterministic=True)
    jeng = run_jax(model, SERVE, requests(2), journal=path + ".jax")
    assert open(path).read().splitlines() == \
        open(path + ".jax").read().splitlines()
    st = read_journal(path)
    assert st.finished == {0, 1}
    for seq in eng.finished:
        assert st.tokens[seq.req.request_id] == seq.generated
    assert engine(model, path).recover() == {
        "recovered": 0, "replayed": 0, "already_finished": 0,
        "terminal_in_journal": 2, "torn_lines": 0, "journal_swaps": 0}
    assert streams(eng) == streams(jeng)


@pytest.mark.parametrize("point,nth", MATRIX, ids=[p for p, _ in MATRIX])
def test_crash_matrix_recovers_bit_identical(model, tmp_path, plain_ref,
                                             point, nth):
    got, _ = crash_and_recover(model, str(tmp_path / "kill.jsonl"), point,
                               nth, requests())
    assert got == plain_ref, f"streams diverged after crash at {point}"


def test_recover_on_crashed_engine_in_place(model, tmp_path, plain_ref):
    path = str(tmp_path / "kill.jsonl")
    eng = engine(model, path)
    with faults.scope("serve.decode.before", "raise", nth=4):
        with pytest.raises(faults.FaultError):
            eng.run([Request(**r) for r in requests()], deterministic=True)
    assert eng.pool.used_blocks == 0 and eng.waiting
    rec = eng.recover()
    assert rec["recovered"] == rec["replayed"] > 0
    eng.run([], deterministic=True)
    assert {s.req.request_id: s.generated for s in eng.finished} == plain_ref


def test_torn_tail_recovery_rederives_lost_tokens(model, tmp_path,
                                                  plain_ref):
    path = str(tmp_path / "torn.jsonl")
    engine(model, path).run([Request(**r) for r in requests()],
                            deterministic=True)
    raw = open(path, "rb").readlines()
    with open(path, "wb") as f:
        f.writelines(raw[:-4])
        f.write(raw[-4][:max(1, len(raw[-4]) // 2)])
    eng2 = engine(model, path)
    assert eng2.recover()["torn_lines"] == 1
    eng2.run([], deterministic=True)
    for s in eng2.finished:
        assert s.generated == plain_ref[s.req.request_id]


def test_journal_knobs(model, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="journal"):
        engine(model, None).recover()
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_JOURNAL", path)
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC", "1")
    eng = engine(model, None)
    assert eng.journal_path == path and eng._journal.fsync
    eng.run([Request(**r) for r in requests(1)], deterministic=True)
    assert read_journal(path).finished == {0}
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC", "often")
    with pytest.raises(ValueError, match="JOURNAL_FSYNC"):
        engine(model, str(tmp_path / "x.jsonl"))
