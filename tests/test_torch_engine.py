"""Port parity: paddle_tpu_torch/inference against paddle_tpu/inference.

The port's engine replays the two deterministic traces of
tests/test_serving_engine.py (the basic one and the eviction one) on the
same weights as the JAX engine: token streams and event logs must be
identical, and the pool leak-free. BlockPool / pad_table are compared
op by op on a scripted sequence. Also pinned: the package imports no JAX
and nothing of paddle_tpu, and its entry points refuse to run without a
CUDA device unless the CPU is asked for.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServeConfig as JaxServeConfig
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import (InferenceEngine, Request,
                                        ServeConfig, kv_cache as tkv)
from paddle_tpu_torch.models import llama as tl


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(scope="module")
def model():
    kw = dict(vocab=96, hidden=64, layers=1, heads=4, kv_heads=2, seq=512)
    jcfg = jl.llama_tiny(**kw)
    params = jl.init_llama_params(jcfg, seed=3)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tl.llama_tiny(**kw), tparams


def _both(model, prompts, serve_kw, max_new):
    jcfg, params, tcfg, tparams = model
    with _common.interpret_mode(True):
        jeng = JaxEngine(params, jcfg, JaxServeConfig(**serve_kw),
                         record_events=True)
        jeng.run([JaxRequest(p, max_new_tokens=max_new, arrival=float(i))
                  for i, p in enumerate(prompts)], deterministic=True)
    teng = InferenceEngine(tparams, tcfg, ServeConfig(**serve_kw),
                           record_events=True, device="cpu")
    stats = teng.run([Request(p, max_new_tokens=max_new, arrival=float(i))
                      for i, p in enumerate(prompts)], deterministic=True)
    return jeng, teng, stats


def _streams(eng):
    return {s.req.request_id: s.tokens for s in eng.finished}


@pytest.fixture(scope="module")
def basic(model):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=n).tolist() for n in (7, 130)]
    return _both(model, prompts, dict(block_size=128, num_blocks=10,
                                      max_batch=2, prefill_chunk=32,
                                      max_seq_len=512), 5)


@pytest.fixture(scope="module")
def evict(model):
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 96, size=120).tolist() for _ in range(3)]
    return _both(model, prompts, dict(block_size=128, num_blocks=5,
                                      max_batch=3, prefill_chunk=64,
                                      max_seq_len=256), 16)


@pytest.mark.parametrize("trace", ["basic", "evict"])
def test_engine_streams_and_events_match_jax(request, trace):
    jeng, teng, stats = request.getfixturevalue(trace)
    assert _streams(teng) == _streams(jeng)
    assert teng.events == jeng.events
    assert stats["requests"] == len(jeng.finished)
    assert stats["preemptions"] == jeng.preemptions
    assert teng.pool.used_blocks == 0
    assert teng.pool.free_blocks == teng.serve.num_blocks - 1


def test_eviction_trace_evicts(evict):
    _, teng, stats = evict
    assert stats["preemptions"] >= 1
    assert any(ev[1] == "evict" for ev in teng.events)
    assert all(len(s.generated) == 16 for s in teng.finished)


def test_engine_counts_steps(basic):
    _, teng, stats = basic
    assert stats["decode_steps"] >= 4 and stats["prefill_chunks"] >= 5
    assert stats["iterations"] == teng.iteration
    assert stats["device"] == "cpu"


def _script(mod):
    """Apply one scripted op sequence; record every observable."""
    pool = mod.BlockPool(num_blocks=8, block_size=128)
    log = []

    def obs(tag, fn):
        try:
            out = fn()
        except ValueError as e:
            out = ("raise", type(e).__name__, str(e))
        log.append((tag, out, pool.free_blocks, pool.used_blocks,
                    pool.available_blocks, pool.utilization,
                    sorted(pool._refs.items()), list(pool._free)))
        return out

    a = obs("alloc3", lambda: pool.alloc(3))
    b = obs("alloc2", lambda: pool.alloc(2))
    obs("alloc_too_many", lambda: pool.alloc(3))
    obs("acquire", lambda: pool.acquire([a[0], b[1]]))
    obs("free_shared_once", lambda: pool.free([a[0]]))
    obs("free_dup_in_call", lambda: pool.free([a[1], a[1]]))
    obs("free_null", lambda: pool.free([0]))
    obs("free_out_of_range", lambda: pool.free([8]))
    obs("acquire_free", lambda: pool.acquire([pool._free[-1]]))
    obs("acquire_range", lambda: pool.acquire([0]))
    obs("free_rest", lambda: pool.free(a + b[1:]))
    obs("free_b0", lambda: pool.free(b[:1]))
    obs("double_free", lambda: pool.free(b[:1]))
    obs("realloc", lambda: pool.alloc(7))
    obs("alloc0", lambda: pool.alloc(0))
    obs("blocks_for", lambda: [pool.blocks_for(n)
                               for n in (-1, 0, 1, 128, 129, 1000)])
    obs("pad", lambda: mod.pad_table([3, 7], 4).tolist())
    obs("pad_dtype", lambda: str(mod.pad_table([], 2).dtype))
    obs("pad_over", lambda: mod.pad_table([1, 2, 3], 2))
    for bad in ((1, 128), (4, 100)):
        obs(f"ctor{bad}", lambda: mod.BlockPool(*bad))
    return log


def test_block_pool_and_pad_table_match_jax():
    got, want = _script(tkv), _script(jkv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g[1] and g[1][0] == "raise":
            # same exception class name and the same offending block;
            # message wording may differ
            assert g[1][1] == w[1][1], (g, w)
            g, w = (g[0],) + g[2:], (w[0],) + w[2:]
        assert g == w


def test_engine_requires_cuda_unless_cpu_named(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tparams = model
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tparams, tcfg, ServeConfig(num_blocks=4))


def test_submit_validation(model):
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(
        block_size=128, num_blocks=4, max_batch=4, max_seq_len=256),
        device="cpu")
    assert eng.serve.decode_buckets == (1, 2, 4)
    with pytest.raises(ValueError):
        ServeConfig(max_batch=4, decode_buckets=(1, 2))
    with pytest.raises(ValueError):
        eng.submit(Request([1] * 250, max_new_tokens=16))   # > max_seq_len
    with pytest.raises(ValueError):
        eng.submit(Request([], max_new_tokens=1))
    # refused requests still drew ids 0 and 1, as in the JAX engine
    assert eng.submit(Request([1, 2, 3], max_new_tokens=2)).request_id == 2
    assert [s.req.request_id for s in eng.waiting] == [2]


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,"
        " 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('paddle_tpu_torch.')]), bad)\n"
        "print(' '.join(m for m in sys.modules"
        " if m.startswith('paddle_tpu_torch.')))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 10
    walked = set(res.stdout.splitlines()[-1].split())
    # the multi-process modules, the rank harness the spawned ranks run,
    # and expert parallelism's exchange and dispatch
    assert {"paddle_tpu_torch.distributed.env",
            "paddle_tpu_torch.distributed.communication",
            "paddle_tpu_torch.distributed.communication.ragged",
            "paddle_tpu_torch.distributed.fleet.topology",
            "paddle_tpu_torch.parallel.moe",
            "paddle_tpu_torch.models.ernie_moe",
            "paddle_tpu_torch.testing.dist"} <= walked
