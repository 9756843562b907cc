"""Helpers shared by the port's serving parity tests
(tests/test_torch_serving_*.py, test_torch_prefix_cache.py,
test_torch_engine_journal*.py, test_torch_metrics_registry.py): the tiny
Llama of the JAX serving tests on both sides, a runner of one request
trace through both engines, and the comparisons."""
import numpy as np

import jax

from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServeConfig as JaxServeConfig
from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common

from paddle_tpu_torch.inference import InferenceEngine, Request, ServeConfig
from paddle_tpu_torch.models import llama as tl


def tiny_model(layers=1, seed=3):
    """(jax cfg, jax params, port cfg, port params on the CPU): the JAX
    serving tests' llama_tiny(vocab=96, hidden=64, heads=4, kv_heads=2)."""
    kw = dict(vocab=96, hidden=64, layers=layers, heads=4, kv_heads=2,
              seq=512)
    jcfg = jl.llama_tiny(**kw)
    params = jl.init_llama_params(jcfg, seed=seed)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tl.llama_tiny(**kw), tparams


def poisoned(model, token=95):
    """The same model with ``token``'s embedding row NaN on both sides (a
    genuine poison input, as tests/test_serving_quarantine.py makes it)."""
    jcfg, params, tcfg, tparams = model
    jparams = dict(params, embed=params["embed"].at[token].set(np.nan))
    tembed = tparams["embed"].clone()
    tembed[token] = float("nan")
    return jcfg, jparams, tcfg, dict(tparams, embed=tembed)


def run_jax(model, serve_kw, trace, deterministic=True, **eng_kw):
    """``trace``: a list of Request keyword dicts."""
    jcfg, params, _, _ = model
    with _common.interpret_mode(True):
        eng = JaxEngine(params, jcfg, JaxServeConfig(**serve_kw),
                        record_events=True, **eng_kw)
        eng.run([JaxRequest(**r) for r in trace],
                deterministic=deterministic)
    return eng


def run_port(model, serve_kw, trace, deterministic=True, **eng_kw):
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**serve_kw),
                          record_events=True, device="cpu", **eng_kw)
    eng.run([Request(**r) for r in trace], deterministic=deterministic)
    return eng


def streams(eng):
    return {s.req.request_id: list(s.tokens) for s in eng.finished}


# stats() entries that hold host times (the first call of each step shape)
TIMED = ("compiles",)


def stats_equal(teng, jeng):
    """The port's stats() against JAX's over every key JAX has: equal
    values, the timed ``compiles`` by key, the port's extra speculative
    entries left out."""
    got, want = teng.stats(), jeng.stats()
    assert list(got)[:len(want)] == list(want)
    for k, w in want.items():
        g = got[k]
        if k == "compiles":
            assert sorted(g) == sorted(w), k
        elif k == "speculative" and w is not None:
            assert {kk: g[kk] for kk in w} == w, k
        else:
            assert g == w, (k, g, w)


def assert_same_run(teng, jeng):
    """Streams, events, outcomes and stats() equal, pools leak-free."""
    assert streams(teng) == streams(jeng)
    assert teng.events == jeng.events
    assert teng.outcomes() == jeng.outcomes()
    stats_equal(teng, jeng)
    assert teng.pool.used_blocks == 0 == jeng.pool.used_blocks
