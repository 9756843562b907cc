"""The port's FleetRouter (paddle_tpu_torch.inference.fleet) against
paddle_tpu's, on the CPU: tests/test_fleet_serving.py's cases, each run on
both sides over the same tiny Llama weights and the same trace.

Held equal in every case: the routing log (request, replica, decision,
accepted), ``streams()``, ``outcomes()`` and the whole of ``stats()``
(routing counters, per-replica routing, hit rate, migrations, rolling
swaps, lost), and the merged Prometheus exposition byte for byte (in
deterministic mode the engines' clocks are the fleet iteration, so no
field of it is a host time). On top, the port's streams equal a lone
port engine's where the JAX test holds JAX's to a lone JAX engine.

The replicas share one weight tree, so a rolling swap of DIFFERENT
weights reaches every replica at the first replica's swap: the JAX
engine rebinds the shared dict's leaves, the port's copies into the
shared tensors. ``test_rolling_swap_of_other_weights_from_a_root_is_jax``
holds that behaviour to JAX's.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.distributed.checkpoint.manager import \
    CheckpointManager as JaxManager
from paddle_tpu.inference import FleetRouter as JaxFleet
from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServeConfig as JaxServeConfig
from paddle_tpu.ops import _common
from paddle_tpu.testing import faults as jfaults

from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                        Request, ServeConfig)

from torch_serve_common import tiny_model


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "1")
    with _common.interpret_mode(True):
        yield
    jfaults.disarm()


@pytest.fixture(scope="module")
def model():
    return tiny_model()


_SERVE_KW = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=32, max_seq_len=256, prefix_cache=True)


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def _jcopy(tree):
    """New dicts over the same JAX arrays: JAX's swap rebinds leaves in
    the shared dict, which must not be the module fixture's."""
    return jax.tree_util.tree_map(lambda a: a, tree)


def _trace(n=8, seed=11, max_new=5):
    """Even requests share a 140-token prefix (a full block of affinity
    bait), odd ones are short and unique."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 90, size=140).tolist()
    out = []
    for i in range(n):
        if i % 2 == 0:
            prompt = shared + rng.randint(1, 90, size=8).tolist()
        else:
            prompt = rng.randint(1, 90, size=24).tolist()
        out.append(dict(prompt=prompt, max_new_tokens=max_new,
                        arrival=float(i)))
    return out


def _skew_trace(n_late, seed=7, late_at=14.0, spacing=1.0):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 90, size=140).tolist()
    out = [dict(prompt=shared + rng.randint(1, 90, size=6).tolist(),
                max_new_tokens=4, arrival=0.0)]
    for i in range(n_late):
        out.append(dict(prompt=shared + rng.randint(1, 90, size=6).tolist(),
                        max_new_tokens=4, arrival=late_at + i * spacing))
    return out


def _fleets(model, tmp_path=None, n=3, serve_kw=None, journal=False, **kw):
    """(port fleet, JAX fleet) over the same weights; journals in
    separate dirs under tmp_path."""
    jcfg, jparams, tcfg, tparams = model
    skw = dict(_SERVE_KW, **(serve_kw or {}))
    jd = td = None
    if journal:
        (tmp_path / "j").mkdir()
        (tmp_path / "t").mkdir()
        jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    tf = FleetRouter(_clone(tparams), tcfg, ServeConfig(**skw), n_replicas=n,
                     journal_dir=td, device="cpu", **kw)
    jf = JaxFleet(_jcopy(jparams), jcfg, JaxServeConfig(**skw), n_replicas=n,
                  journal_dir=jd, **kw)
    return tf, jf


def _run_both(tf, jf, trace, **run_kw):
    jkw = dict(run_kw)
    tkw = dict(run_kw)
    if "swap_source" in run_kw:
        tkw["swap_source"], jkw["swap_source"] = run_kw["swap_source"]
    ts = tf.run([Request(**r) for r in trace], deterministic=True, **tkw)
    js = jf.run([JaxRequest(**r) for r in trace], deterministic=True, **jkw)
    assert_same(tf, jf, ts, js)
    return ts


def assert_same(tf, jf, ts, js):
    assert tf.routing_log == jf.routing_log
    assert tf.streams() == jf.streams()
    assert tf.outcomes() == jf.outcomes()
    assert ts == js
    assert tf.last_rolling_swap == jf.last_rolling_swap
    assert tf.alive == jf.alive and tf.dead == jf.dead
    assert [e.pool.used_blocks for e in tf.engines] == \
        [e.pool.used_blocks for e in jf.engines]


def _reference(model, trace):
    """Streams of the trace on ONE lone port engine: the bit-identity
    oracle of every fleet scenario."""
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**_SERVE_KW),
                          device="cpu")
    reqs = [Request(**r) for r in trace]
    for i, r in enumerate(reqs):
        r.request_id = i
    eng.run(reqs, deterministic=True)
    return {s.req.request_id: list(s.generated) for s in eng.finished}


# -- routing determinism ------------------------------------------------------

def test_single_replica_matches_lone_engine(model):
    tf, jf = _fleets(model, n=1)
    stats = _run_both(tf, jf, _trace())
    assert tf.streams() == _reference(model, _trace())
    assert stats["lost"] == 0 and stats["requests"] == 8


def test_routing_replays_identically(model, tmp_path):
    runs = []
    for rep in range(2):
        d = tmp_path / f"run{rep}"
        d.mkdir()
        tf, jf = _fleets(model, d, journal=True)
        _run_both(tf, jf, _trace())
        runs.append((tf.routing_log, tf.streams(),
                     [{s.req.request_id: list(s.generated)
                       for s in e.finished} for e in tf.engines]))
        assert runs[-1][2] == [{s.req.request_id: list(s.generated)
                                for s in e.finished} for e in jf.engines]
    assert runs[0] == runs[1]


def test_affinity_concentrates_shared_prefix(model):
    trace = _skew_trace(n_late=3)
    tf, jf = _fleets(model, spill=100)   # no spill: pure affinity
    stats = _run_both(tf, jf, trace)
    assert stats["affinity_hits"] == 3
    warm = tf.assignments[0]
    assert all(tf.assignments[rid] == warm for rid in (1, 2, 3))
    assert tf.assignments == jf.assignments
    assert tf.streams() == _reference(model, trace)
    rt, rj = _fleets(model, policy="random", seed=5)
    _run_both(rt, rj, trace)
    aff = [e.cache.hit_tokens for e in tf.engines]
    rnd = [e.cache.hit_tokens for e in rt.engines]
    assert aff == [e.cache.hit_tokens for e in jf.engines]
    assert rnd == [e.cache.hit_tokens for e in rj.engines]
    assert sum(aff) >= sum(rnd)
    assert rt.streams() == tf.streams()   # policy never alters tokens


def test_prefix_skew_spills_past_saturated_replica(model):
    tf, jf = _fleets(model, spill=2)
    stats = _run_both(tf, jf, _skew_trace(n_late=8, spacing=0.0))
    assert stats["spills"] > 0
    assert len([n for n in stats["routed_per_replica"] if n > 0]) >= 2
    assert stats["lost"] == 0 and stats["requests"] == 9


def test_router_validation(model):
    _, _, tcfg, tparams = model
    for kw, match in ((dict(n_replicas=0), "n_replicas"),
                      (dict(policy="round-robin"), "policy"),
                      (dict(spill=0), "spill")):
        with pytest.raises(ValueError, match=match):
            FleetRouter(tparams, tcfg, ServeConfig(**_SERVE_KW),
                        device="cpu", **dict(dict(n_replicas=3), **kw))
    if not torch.cuda.is_available():
        # device=None means the card
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetRouter(tparams, tcfg, ServeConfig(**_SERVE_KW))


def test_env_knobs_supply_defaults(model, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLEET_SERVE_REPLICAS", "2")
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLEET_SERVE_SPILL", "7")
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLEET_SERVE_JOURNAL_DIR",
                       str(tmp_path))
    _, _, tcfg, tparams = model
    fleet = FleetRouter(tparams, tcfg, ServeConfig(**_SERVE_KW),
                        device="cpu")
    assert fleet.n == 2 and fleet.spill == 7
    assert fleet.engines[0].journal_path == str(tmp_path / "replica_0.jsonl")
    # explicit arguments out-rank the environment; JAX's knobs are not read
    monkeypatch.setenv("PADDLE_TPU_FLEET_SERVE_REPLICAS", "5")
    fleet2 = FleetRouter(tparams, tcfg, ServeConfig(**_SERVE_KW),
                         n_replicas=3, spill=4, device="cpu")
    assert fleet2.n == 3 and fleet2.spill == 4


# -- journal migration under a seeded kill ------------------------------------

def test_kill_mid_burst_migrates_bit_identically(model, tmp_path):
    tf, jf = _fleets(model, tmp_path, journal=True)
    stats = _run_both(tf, jf, _trace(), kill_at=(6, 0))
    assert not tf.alive[0]
    assert stats["migrations"] > 0 and stats["lost"] == 0
    assert tf.lost_requests() == []
    assert tf.streams() == _reference(model, _trace())
    assert all(e.pool.used_blocks == 0 for e in tf.engines)


def test_seeded_kill_replays_identically(model, tmp_path):
    runs = []
    for rep in range(2):
        d = tmp_path / f"kill{rep}"
        d.mkdir()
        tf, jf = _fleets(model, d, journal=True)
        stats = _run_both(tf, jf, _trace(), kill_at=(5, 1))
        runs.append((tf.routing_log, tf.streams(), stats["migrations"]))
    assert runs[0] == runs[1] and runs[0][2] > 0


def test_kill_without_journal_migrates_queue(model):
    tf, jf = _fleets(model)
    stats = _run_both(tf, jf, _trace(), kill_at=(4, 2))
    assert stats["lost"] == 0
    assert tf.streams() == _reference(model, _trace())


def test_kill_needs_a_survivor(model):
    tf, jf = _fleets(model, n=1)
    for f in (tf, jf):
        with pytest.raises(RuntimeError, match="surviving"):
            f.kill_replica(0)
    tf, jf = _fleets(model, n=3)
    assert tf.kill_replica(1) == jf.kill_replica(1) == \
        {"replica": 1, "migrated": 0}
    for f in (tf, jf):
        with pytest.raises(ValueError, match="already dead"):
            f.kill_replica(1)


# -- rolling fleet-wide weight swap -------------------------------------------

def test_rolling_swap_zero_drops(model):
    jcfg, jparams, tcfg, tparams = model
    tf, jf = _fleets(model)
    stats = _run_both(tf, jf, _trace(), rolling_swap_at=3,
                      swap_source=(_clone(tparams), _jcopy(jparams)))
    assert stats["rolling_swaps"] == 3
    assert tf.last_rolling_swap == {"swapped": [0, 1, 2]}
    assert stats["lost"] == 0 and stats["requests"] == 8
    assert tf.streams() == _reference(model, _trace())
    for e in tf.engines:
        assert e.last_swap is not None
        assert e.last_swap["in_flight_running"] == 0
        assert e.last_swap["in_flight_prefill"] == 0


def test_rolling_swap_with_kill_skips_dead_replica(model, tmp_path):
    jcfg, jparams, tcfg, tparams = model
    tf, jf = _fleets(model, tmp_path, journal=True)
    stats = _run_both(tf, jf, _trace(), kill_at=(4, 1), rolling_swap_at=2,
                      swap_source=(_clone(tparams), _jcopy(jparams)))
    assert stats["rolling_swaps"] == 2
    assert 1 not in tf.last_rolling_swap["swapped"]
    assert stats["lost"] == 0
    assert tf.streams() == _reference(model, _trace())


def test_single_replica_rolling_swap_keeps_serving(model):
    jcfg, jparams, tcfg, tparams = model
    tf, jf = _fleets(model, n=1)
    stats = _run_both(tf, jf, _trace(n=4), rolling_swap_at=1,
                      swap_source=(_clone(tparams), _jcopy(jparams)))
    assert stats["rolling_swaps"] == 1
    assert stats["requests"] == 4 and stats["lost"] == 0


def test_rolling_swap_of_other_weights_from_a_root_is_jax(model, tmp_path):
    """A rolling swap whose source is a CheckpointManager root holding
    DIFFERENT weights (a train state's "params"): the shared tree takes
    them at the first replica's swap, on both sides alike, so the later
    replicas' swaps rewrite the same values and streams after the first
    swap follow the new weights on every replica."""
    jcfg, jparams, tcfg, tparams = model
    _, j2, _, t2 = tiny_model(seed=11)
    jm = JaxManager(str(tmp_path / "jroot"), keep=1)
    jm.save({"params": j2, "step": 7}, 7, block=True)
    tm = CheckpointManager(str(tmp_path / "troot"), keep=1)
    tm.save({"params": t2, "step": 7}, 7, block=True)
    tf, jf = _fleets(model)
    trace = _trace(n=10)
    stats = _run_both(tf, jf, trace, rolling_swap_at=3,
                      swap_source=(str(tmp_path / "troot"),
                                   str(tmp_path / "jroot")))
    assert stats["rolling_swaps"] == 3 and stats["lost"] == 0
    assert [e.last_swap["iteration"] for e in tf.engines] == \
        [e.last_swap["iteration"] for e in jf.engines]
    assert [e.last_swap["source"] for e in tf.engines] == [tm.step_dir(7)] * 3
    # one tree, holding the new weights, behind every replica
    assert all(e.params is tf.engines[0].params for e in tf.engines)
    assert torch.equal(tf.engines[0].params["embed"], t2["embed"])
    old = _reference(model, trace)
    new = _reference(tiny_model(seed=11), trace)
    got = tf.streams()
    assert any(got[r] != old[r] for r in got)
    assert got[max(got)] == new[max(got)]


# -- drain() and adopt() ------------------------------------------------------

def test_engine_drain_rejects_then_completes(model):
    jcfg, jparams, tcfg, tparams = model
    outs = []
    for eng, req in ((InferenceEngine(tparams, tcfg,
                                      ServeConfig(**_SERVE_KW),
                                      device="cpu"), Request),
                     (JaxEngine(jparams, jcfg, JaxServeConfig(**_SERVE_KW)),
                      JaxRequest)):
        trace = _trace(n=4)
        for i, r in enumerate(trace):
            eng.submit(req(**dict(r, arrival=0.0), request_id=i))
        outcomes = eng.drain(deterministic=True)
        assert all(st == "finished" for st, _ in outcomes.values())
        assert eng.idle() and eng.pool.used_blocks == 0
        adm = eng.submit(req(list(trace[0]["prompt"]), max_new_tokens=3,
                             request_id=99))
        eng.undrain()
        adm2 = eng.submit(req(list(trace[1]["prompt"]), max_new_tokens=3,
                              request_id=100))
        outs.append((outcomes, adm.accepted, adm.cause, adm2.accepted,
                     eng.outcomes()[99]))
    assert outs[0] == outs[1]
    assert outs[0][1:] == (False, "draining", True,
                           ("rejected", "draining"))


def test_adopt_bypasses_admission(model):
    jcfg, jparams, tcfg, tparams = model
    gens = []
    for eng, req in ((InferenceEngine(tparams, tcfg, ServeConfig(
            max_queue=1, **_SERVE_KW), device="cpu"), Request),
                     (JaxEngine(jparams, jcfg, JaxServeConfig(
                         max_queue=1, **_SERVE_KW)), JaxRequest)):
        eng.drain(deterministic=True)
        eng.adopt(req([5, 6, 7, 8], max_new_tokens=3, request_id=0),
                  generated=[9])
        assert len(eng.waiting) == 1 and list(eng.waiting[0].generated) == [9]
        eng.undrain()
        eng.run([], deterministic=True)
        (s,) = eng.finished
        gens.append(list(s.generated))
    assert gens[0] == gens[1] and gens[0][0] == 9


# -- fleet exposition ---------------------------------------------------------

def test_fleet_prometheus_is_jax_bytes(model, tmp_path):
    tf, jf = _fleets(model, tmp_path, journal=True)
    _run_both(tf, jf, _trace(), kill_at=(6, 0))
    text = tf.render_prometheus()
    assert text == jf.render_prometheus()
    assert 'paddle_tpu_serve_finished_requests{replica="1"}' in text
    assert 'paddle_tpu_serve_ttft_seconds_bucket{replica="2",le=' in text
    assert "paddle_tpu_fleet_replicas 3" in text
    assert "paddle_tpu_fleet_replicas_live 2" in text
    snap = tf.metrics_snapshot()
    assert snap == jf.metrics_snapshot()
    assert snap["migrations"] == tf.migrations > 0
    assert snap["finished_requests"] == 8
    assert snap["generated_tokens"] == sum(
        len(t) for t in tf.streams().values())
