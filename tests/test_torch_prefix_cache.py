"""Port parity: the prefix cache of paddle_tpu_torch against paddle_tpu's
(tests/test_prefix_cache.py's traces).

BlockPool and PrefixCache are driven op by op through one scripted
sequence with sharing, parking, LRU reclaim and invalidation on both
sides, every observable compared. The engine replays the cached traces:
streams, events, outcomes, stats() (hits, hit tokens, COW copies) equal
the JAX engine's, a hit is bitwise the cold run, and the copy-on-write
blit copies the base, scale and draft pools' slabs exactly.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.ops import _common

import paddle_tpu_torch.inference.engine as engine_mod
from paddle_tpu_torch.inference import (BlockPoolError, InferenceEngine,
                                        Request, ServeConfig,
                                        kv_cache as tkv)

from torch_serve_common import assert_same_run, run_jax, run_port, \
    streams, tiny_model


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _script(mod):
    """One scripted op sequence over a pool of 7 blocks and its index;
    every observable after every op."""
    pool = mod.BlockPool(7, 128)
    cache = mod.PrefixCache(pool)
    log = []

    def snap(tag):
        log.append((tag, pool.free_blocks, pool.cached_blocks,
                    pool.available_blocks, pool.used_blocks,
                    round(pool.utilization, 6),
                    tuple(pool.ref_count(b) for b in range(7)),
                    tuple(pool.is_registered(b) for b in range(7)),
                    len(cache), tuple(sorted(cache.stats().items()))))

    a = list(range(1, 400))
    b = list(range(1, 200)) + [7] * 100
    blocks = pool.alloc(3)
    log.append(("alloc", blocks))
    log.append(("register", cache.register(a, blocks, 3)))
    snap("registered")
    hit = cache.match(a, 3)
    log.append(("match", hit))
    pool.acquire(hit[:2])
    snap("shared")
    log.append(("match_len", cache.match_len(b, 2),
                cache.match_len(b, 2, set(cache.prospective_keys(b, 2)))))
    pool.free(blocks)
    snap("first owner gone")
    pool.free(hit[:2])
    snap("parked")
    log.append(("alloc2", pool.alloc(2)))
    snap("free list first")
    got = pool.alloc(2)                      # reclaims LRU-oldest parked
    log.append(("alloc3", got))
    snap("reclaimed")
    log.append(("match after reclaim", cache.match(a, 3)))
    cache.invalidate_block(hit[1]) if pool.is_registered(hit[1]) else None
    snap("invalidated")
    for bad in ([0], [99], [got[0], got[0]]):
        try:
            pool.free(bad)
        except mod.BlockPoolError as e:
            log.append(("refused", str(e)))
    snap("refusals change nothing")
    log.append(("bytes", mod.pool_bytes_per_rank(
        [np.zeros((2, 7, 32, 128), np.float32), None])
        if mod is jkv else tkv.pool_bytes_per_rank(
            [torch.zeros((2, 7, 32, 128)), None])))
    return log


def test_pool_and_index_op_by_op_match_jax():
    assert _script(tkv) == _script(jkv)
    assert issubclass(BlockPoolError, ValueError)


def _trace(prompts):
    return [dict(prompt=list(p), max_new_tokens=m, arrival=a)
            for p, m, a in prompts]


def _serve(**kw):
    return dict(dict(block_size=128, num_blocks=12, max_batch=2,
                     prefill_chunk=64, max_seq_len=512), **kw)


def test_cached_hit_matches_jax_and_cold(model):
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 96, size=300).tolist()
    trace = _trace([(prompt, 4, 0.0), (prompt, 4, 50.0)])
    warm = run_port(model, _serve(prefix_cache=True), trace)
    assert_same_run(warm, run_jax(model, _serve(prefix_cache=True), trace))
    pc = warm.stats()["prefix_cache"]
    assert pc["hits"] == 1 and pc["hit_tokens"] == 256
    assert streams(warm) == streams(run_port(model, _serve(), trace))
    assert any(e[1:] == ("prefix_hit", 1, 2) for e in warm.events)
    assert warm.pool.cached_blocks == pc["entries"] > 0


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_eviction_under_pressure_matches_jax(model, kv_dtype):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 96, size=260).tolist() for _ in range(4)]
    trace = _trace([(p, 3, float(10 * i)) for i, p in enumerate(prompts)])
    kw = _serve(num_blocks=8, prefix_cache=True, kv_dtype=kv_dtype)
    teng = run_port(model, kw, trace)
    assert_same_run(teng, run_jax(model, kw, trace))
    assert teng.stats()["prefix_cache"]["reclaimed"] > 0
    assert streams(teng) == streams(run_port(
        model, _serve(num_blocks=8, kv_dtype=kv_dtype), trace))


def test_replay_with_shared_prompts_matches_jax(model):
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 96, size=280).tolist()
    other = rng.randint(1, 96, size=40).tolist()
    trace = _trace([(shared, 3, 0.0), (other, 3, 1.0), (shared, 3, 40.0),
                    (shared + [5, 6], 3, 41.0)])
    kw = _serve(prefix_cache=True)
    a, b = run_port(model, kw, trace), run_port(model, kw, trace)
    assert a.events == b.events and streams(a) == streams(b)
    assert_same_run(a, run_jax(model, kw, trace))
    assert a.stats()["prefix_cache"]["hits"] >= 2


def test_speculative_replay_with_cache_matches_jax(model):
    rng = np.random.RandomState(6)
    shared = rng.randint(1, 96, size=150).tolist()
    trace = _trace([(shared, 6, float(i)) for i in range(3)])
    kw = _serve(prefix_cache=True, speculative=True, draft_k=3,
                max_seq_len=256)
    teng = run_port(model, kw, trace)
    assert_same_run(teng, run_jax(model, kw, trace))
    assert teng.stats()["prefix_cache"]["hits"] >= 1


def test_burst_admission_admits_more_with_cache(model):
    _, _, tcfg, tparams = model

    def admitted(prefix_cache):
        eng = InferenceEngine(tparams, tcfg, ServeConfig(**_serve(
            num_blocks=5, overcommit=1.0, max_queue=16,
            prefix_cache=prefix_cache)), device="cpu")
        prompt = np.random.RandomState(4).randint(1, 96, size=300).tolist()
        return sum(eng.submit(Request(list(prompt), max_new_tokens=4))
                   .accepted for _ in range(4))

    assert admitted(True) > admitted(False)


def _shared_engine(model, **kw):
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 96, size=300).tolist()
    eng = run_port(model, _serve(prefix_cache=True, max_seq_len=384, **kw),
                   [dict(prompt=prompt, max_new_tokens=3)])
    return eng, prompt


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8"),
                                dict(speculative=True, draft_k=2)],
                         ids=["bf16-pools", "int8", "draft"])
def test_cow_blit_copies_every_pool_slab(model, kw):
    """_cow_span on a genuinely shared block: the writer gets a private
    copy, every pool's slab (base, scales, draft) of it starts bitwise
    equal to the shared block's, and the readers' bytes are unchanged."""
    eng, prompt = _shared_engine(model, **kw)
    hit = eng.cache.match(prompt, 2)
    assert len(hit) == 2
    eng.pool.acquire(hit)
    eng.pool.acquire(hit)
    b = hit[0]
    pools = [p for p in (eng.k_pool, eng.v_pool, eng.k_scale, eng.v_scale,
                         eng.k_draft, eng.v_draft) if p is not None]
    before = [p[:, b].clone() for p in pools]
    writer = engine_mod._Seq(Request(prompt, max_new_tokens=1,
                                     request_id=99), 0.0)
    writer.blocks = list(hit)
    assert eng._cow_span(writer, 0, 1)
    nb = writer.blocks[0]
    assert nb != b and eng.pool.ref_count(b) == 1
    for p, was in zip(pools, before):
        assert torch.equal(p[:, b], was) and torch.equal(p[:, nb], was)
    assert eng.stats()["prefix_cache"]["cow_copies"] == 1
    eng.pool.free(writer.blocks)
    eng.pool.free(hit[1:])
    eng.pool.free([b])
    assert eng.pool.used_blocks == 0


def test_cow_sole_owner_invalidates_index_entry(model):
    eng, prompt = _shared_engine(model)
    hit = eng.cache.match(prompt, 1)
    eng.pool.acquire(hit)
    writer = engine_mod._Seq(Request(prompt, max_new_tokens=1,
                                     request_id=98), 0.0)
    writer.blocks = list(hit)
    assert eng._cow_span(writer, 0, 1)
    assert writer.blocks == hit and not eng.pool.is_registered(hit[0])
    assert eng.cache.match(prompt, 1) == []
    assert eng.stats()["prefix_cache"]["invalidated"] == 1
    eng.pool.free(hit)


def test_env_knob_enables_prefix_cache(model, monkeypatch):
    _, _, tcfg, tparams = model
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_PREFIX_CACHE", "1")
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**_serve()),
                          device="cpu")
    assert eng.cache is not None
    assert InferenceEngine(tparams, tcfg, ServeConfig(**_serve(
        prefix_cache=False)), device="cpu").cache is None
    monkeypatch.setenv("PADDLE_TPU_TORCH_SERVE_PREFIX_CACHE", "maybe")
    with pytest.raises(ValueError, match="PREFIX_CACHE"):
        InferenceEngine(tparams, tcfg, ServeConfig(**_serve()), device="cpu")
