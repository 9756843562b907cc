"""Port parity: the crash matrix of tests/test_engine_journal.py with the
prefix cache and int8 KV on, and with speculation, the prefix cache and
int8 KV on, on the port's engine; and recovery across configurations.

Each variant's uncrashed run equals the JAX engine's (streams and journal
lines); every crash point recovers to exactly that run, leak-free, and a
speculative engine's journal holds only verified tokens at every crash.
A journal crosses to a bigger pool, the prefix cache or speculation
unchanged; across kv_dtype or onto a pool or max_seq_len that can never
serve it, recover() refuses before touching any state.
"""
import shutil

import numpy as np
import pytest

from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import JournalCompatError, Request, \
    read_journal
from paddle_tpu_torch.testing import faults

from test_torch_engine_journal import (MATRIX, crash_and_recover, engine,
                                       requests, uncrashed)
from torch_serve_common import tiny_model


@pytest.fixture(autouse=True)
def _faults(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_FAULTS", "1")
    with _common.interpret_mode(True):
        yield
    faults.disarm()


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def shared_requests(n=3, max_new=6, seed=7):
    """Identical 150-token prompts: one full shared block, so the prefix
    cache registers and hits across the trace."""
    prompt = np.random.RandomState(seed).randint(1, 96, size=150).tolist()
    return [dict(prompt=list(prompt), max_new_tokens=max_new,
                 arrival=float(i), request_id=i) for i in range(n)]


VARIANTS = {
    "cached-int8": dict(prefix_cache=True, kv_dtype="int8"),
    "spec-int8": dict(prefix_cache=True, kv_dtype="int8", speculative=True,
                      draft_k=3),
}


@pytest.fixture(scope="module")
def refs(model, tmp_path_factory):
    out = {}
    for name, kw in VARIANTS.items():
        path = str(tmp_path_factory.mktemp(name) / "ref.jsonl")
        out[name] = uncrashed(model, path, shared_requests(), **kw)
        assert len(out[name]) == 3
        assert len({tuple(t) for t in out[name].values()}) == 1
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("point,nth", MATRIX, ids=[p for p, _ in MATRIX])
def test_crash_matrix_with_capacity_features(model, tmp_path, refs,
                                             variant, point, nth):
    got, mid = crash_and_recover(model, str(tmp_path / "kill.jsonl"), point,
                                 nth, shared_requests(), **VARIANTS[variant])
    assert got == refs[variant], f"streams diverged after crash at {point}"
    # every token on disk at the crash is a verified prefix of its stream
    for rid, toks in mid.tokens.items():
        assert list(toks) == refs[variant][rid][:len(toks)]


def _crashed_journal(model, tmp_path, trace=None, **kw):
    path = str(tmp_path / "cross.jsonl")
    eng = engine(model, path, **kw)
    with faults.scope("serve.decode.before", "raise", nth=3) as plan:
        with pytest.raises(faults.FaultError):
            eng.run([Request(**r) for r in trace or requests()],
                    deterministic=True)
        assert plan.fired == 1
    return path


@pytest.mark.parametrize("succ_kw", [
    dict(num_blocks=24), dict(prefix_cache=True),
    dict(speculative=True, draft_k=3)],
    ids=["bigger-pool", "prefix-cache-on", "speculative-on"])
def test_cross_config_recovery_bit_identical(model, tmp_path, succ_kw):
    ref_eng = engine(model, None)
    ref_eng.run([Request(**r) for r in requests()], deterministic=True)
    ref = {s.req.request_id: s.generated for s in ref_eng.finished}
    p = str(tmp_path / "succ.jsonl")
    shutil.copy(_crashed_journal(model, tmp_path), p)
    eng2 = engine(model, p, **succ_kw)
    eng2.recover()
    journaled = ({s.req.request_id for s in eng2.waiting}
                 | {s.req.request_id for s in eng2.finished})
    eng2.run([Request(r["prompt"], max_new_tokens=r["max_new_tokens"],
                      request_id=r["request_id"])
              for r in requests() if r["request_id"] not in journaled],
             deterministic=True)
    assert {s.req.request_id: s.generated for s in eng2.finished} == ref
    assert eng2.pool.used_blocks == 0


def test_cross_kv_dtype_recovery_refuses_up_front(model, tmp_path):
    eng2 = engine(model, _crashed_journal(model, tmp_path), kv_dtype="int8")
    with pytest.raises(JournalCompatError, match="kv_dtype"):
        eng2.recover()
    assert eng2.idle() and eng2.pool.used_blocks == 0
    (tmp_path / "r").mkdir()
    eng3 = engine(model, _crashed_journal(model, tmp_path / "r",
                                          kv_dtype="int8"))
    with pytest.raises(JournalCompatError, match="kv_dtype"):
        eng3.recover()


def test_cross_capacity_recovery_refuses_up_front(model, tmp_path):
    path = _crashed_journal(model, tmp_path, trace=shared_requests())
    p1 = str(tmp_path / "seqlen.jsonl")
    shutil.copy(path, p1)
    with pytest.raises(JournalCompatError, match="max_seq_len"):
        engine(model, p1, max_seq_len=128).recover()
    p2 = str(tmp_path / "pool.jsonl")
    shutil.copy(path, p2)
    eng = engine(model, p2, num_blocks=2)
    with pytest.raises(JournalCompatError, match="never fit"):
        eng.recover()
    assert eng.idle() and eng.pool.used_blocks == 0
    assert read_journal(p2).torn_lines == 0
