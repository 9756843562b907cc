"""Port parity: paddle_tpu_torch's MetricsRegistry and the engine's
Prometheus exposition against paddle_tpu's.

The registry is driven through the same script on both sides (counters,
setter and callback gauges, summaries, labeled families, escaping, merge)
and must render the same bytes. The engine's ``render_prometheus()`` after
a deterministic replay is byte-identical to the JAX engine's (the default
exposition, with the prefix cache on, with speculation on), and
``metrics_snapshot()`` keeps JAX's keys in JAX's order.
"""
import numpy as np
import pytest

from paddle_tpu.observability import histogram as jhist
from paddle_tpu.observability import registry as jreg
from paddle_tpu.ops import _common

from paddle_tpu_torch.observability import histogram as thist
from paddle_tpu_torch.observability import registry as treg

from torch_serve_common import run_jax, run_port, tiny_model


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _script(reg_mod, hist_mod):
    r = reg_mod.MetricsRegistry(prefix="p")
    c = r.counter("reqs_total", help="requests\nserved")
    c.inc(3)
    g = r.gauge("depth", help='a "depth" \\ gauge')
    g.set(4)
    g.inc(0.5)
    r.gauge("live", fn=lambda: 7)
    r.gauge("missing", fn=lambda: None)
    s = r.summary("lat_seconds", help="latency")
    for v in (1e-3, 2e-3, 0.5, 3.0, 3.0, 1e5, 0.0):
        s.observe(v)
    fam = r.family("hop_ms", "gauge", labelnames=("site",), help="hops")
    fam.labels(site='tp"ring').set(3.25)
    fam.labels(site="pp\nsend").set(1)
    hfam = r.family("wait_seconds", "histogram", labelnames=("q",))
    hfam.labels(q="a").observe(0.02)
    errors = []
    for bad in (lambda: r.gauge("depth"), lambda: c.inc(-1),
                lambda: fam.labels(other="x"),
                lambda: r.gauge("live").set(1)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    snap = r.snapshot()
    snap = {k: (v.to_dict() if hasattr(v, "to_dict") else
                {kk: (vv.to_dict() if hasattr(vv, "to_dict") else vv)
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in snap.items()}
    legacy = hist_mod.render_prometheus({"lat_seconds": s.hist, "n": 2},
                                        prefix="p")
    return r.render_prometheus(), snap, errors, legacy


def test_registry_script_renders_jax_bytes():
    assert _script(treg, thist) == _script(jreg, jhist)


SERVE = dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
             max_seq_len=512)


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _trace(seed=0, sizes=(7, 40, 140), max_new=4):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 96, size=140).tolist()
    prompts = [rng.randint(1, 96, size=n).tolist() for n in sizes]
    prompts.append(list(shared))
    prompts.append(shared + [3])
    return [dict(prompt=p, max_new_tokens=max_new, arrival=float(2 * i))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("kw", [
    dict(), dict(prefix_cache=True),
    dict(speculative=True, draft_k=3, prefix_cache=True)],
    ids=["default", "prefix-cache", "speculative"])
def test_engine_exposition_is_byte_identical_to_jax(model, kw):
    serve = dict(SERVE, **kw)
    jeng = run_jax(model, serve, _trace())
    teng = run_port(model, serve, _trace())
    assert teng.render_prometheus() == jeng.render_prometheus()
    assert list(teng.metrics_snapshot()) == list(jeng.metrics_snapshot())
    assert "paddle_tpu_serve_ttft_seconds_count" in teng.render_prometheus()
    with pytest.raises(ValueError, match="duplicate"):
        teng.registry.gauge("queue_depth")


def test_chip_smoke_snapshot_keys_are_jax_engines(model):
    """chip_smoke's serve-ops phase holds the card's metrics_snapshot()
    keys to OPS_SNAPSHOT_KEYS (it cannot import JAX there): they must be
    the JAX engine's keys for a config without the cache and speculation."""
    from chip_smoke import OPS_SNAPSHOT_KEYS
    jeng = run_jax(model, SERVE, _trace())
    assert list(jeng.metrics_snapshot()) == OPS_SNAPSHOT_KEYS
