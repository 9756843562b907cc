"""Port parity: the dp and ZeRO sharding layout of paddle_tpu_torch's Llama
train step against paddle_tpu's, on the CPU, in one process.

- ``param_pspecs``, ``opt_state_pspecs`` and ``_act_spec`` equal JAX's,
  each JAX ``PartitionSpec`` read as a tuple of axis names, over dp in
  {1, 2}, sharding in {1, 2, 4}, ZeRO stages 1-3, tied and untied
  embeddings.
- ``make_mesh`` and the topology's rank coordinates and lines of ranks
  equal the device positions of JAX's ``make_mesh`` over its 8 virtual
  CPU devices (device r is rank r).
- ``shard_train_state`` raises ValueError naming the leaf exactly where
  JAX's ``build_train_step`` raises placing the leaf on the mesh (a
  dimension its ranks do not divide). These run under torch's in-process
  ``fake`` process-group backend (no communication), one rank at a time.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax

from paddle_tpu.models import llama as jl

from paddle_tpu_torch.distributed.fleet import CommunicateTopology
from paddle_tpu_torch.models import llama as tl


def _tuples(tree):
    """A spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("sharding", [1, 2, 4])
@pytest.mark.parametrize("dp", [1, 2])
def test_pspecs_match_jax(dp, sharding, stage, tied):
    jcfg = dataclasses.replace(jl.llama_tiny(), tie_word_embeddings=tied)
    tcfg = dataclasses.replace(tl.llama_tiny(), tie_word_embeddings=tied)
    jpar = jl.ParallelConfig(dp=dp, sharding=sharding, zero_stage=stage)
    tpar = tl.ParallelConfig(dp=dp, sharding=sharding, zero_stage=stage)
    jspecs = jl.param_pspecs(jcfg, jpar)
    tspecs = tl.param_pspecs(tcfg, tpar)
    assert tspecs == _tuples(jspecs)
    assert tl.opt_state_pspecs(tcfg, tpar, tspecs) == _tuples(
        jl.opt_state_pspecs(jcfg, jpar, jspecs))
    assert tl._act_spec(tpar) == tuple(jl._act_spec(jpar))


@pytest.mark.parametrize("sep", [1, 2])
@pytest.mark.parametrize("sharding", [1, 2])
def test_act_spec_matches_jax(sharding, sep):
    jspec = jl._act_spec(jl.ParallelConfig(dp=2, sharding=sharding, sep=sep))
    assert tl._act_spec(tl.ParallelConfig(dp=2, sharding=sharding,
                                          sep=sep)) == tuple(jspec)


@pytest.mark.parametrize("dims", [(2, 1, 1, 1, 1), (1, 1, 2, 1, 1),
                                  (2, 1, 2, 1, 1), (2, 1, 4, 1, 1),
                                  (2, 2, 2, 1, 1), (1, 2, 1, 2, 2),
                                  (2, 1, 1, 2, 2)])
def test_mesh_and_topology_match_jax(dims):
    names = ("dp", "pp", "sharding", "sep", "mp")
    kw = dict(zip(names, dims))
    jpar, tpar = jl.ParallelConfig(**kw), tl.ParallelConfig(**kw)
    devs = jax.devices("cpu")
    where = {d.id: i for i, d in enumerate(devs)}
    jmesh = jl.make_mesh(jpar, devs)
    positions = np.vectorize(lambda d: where[d.id])(jmesh.devices)
    assert jmesh.axis_names == names
    np.testing.assert_array_equal(tl.make_mesh(tpar), positions)
    topo = CommunicateTopology(list(names), list(dims))
    for r in range(tpar.total):
        assert topo.get_coord(r) == tuple(
            int(i) for i in np.argwhere(positions == r)[0])
        assert topo.get_rank(**dict(zip(names, topo.get_coord(r)))) == r
    for axis, name in enumerate(names):
        lines = np.moveaxis(positions, axis, -1).reshape(-1, dims[axis])
        assert topo.get_comm_list(name) == lines.tolist()


@pytest.fixture
def fake_rank():
    """Run under a fake process group of ``world`` ranks as ``rank``."""
    def init(rank, world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _np_params(cfg):
    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(cfg, 0))


# (layers, hidden, heads): 3 layers do not divide over 2 or 4 ranks, a
# hidden of 66 not over 4
SHAPES = [(3, 64, 4), (2, 66, 3), (4, 64, 4)]


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("sharding", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_shard_raises_where_jax_raises(fake_rank, shape, sharding, stage):
    layers, hidden, heads = shape
    jcfg = jl.llama_tiny(vocab=96, hidden=hidden, layers=layers, heads=heads,
                         kv_heads=heads, inter=128)
    tcfg = tl.llama_tiny(vocab=96, hidden=hidden, layers=layers, heads=heads,
                         kv_heads=heads, inter=128)
    jpar = jl.ParallelConfig(sharding=sharding, zero_stage=stage,
                             use_flash=False)
    try:
        jl.build_train_step(jcfg, jpar, mesh=jl.make_mesh(
            jpar, jax.devices("cpu")))
        jax_raised = False
    except ValueError:
        jax_raised = True
    full = tl.params_from_numpy(_np_params(jcfg), "cpu")
    tpar = tl.ParallelConfig(sharding=sharding, zero_stage=stage)
    fake_rank(sharding - 1, sharding)
    if jax_raised:
        with pytest.raises(ValueError, match="does not divide"):
            tl.shard_train_state(full, tl._adamw_init(full), tcfg, tpar)
    else:
        p, o = tl.shard_train_state(full, tl._adamw_init(full), tcfg, tpar)
        d = 1 if stage == 3 else 0
        q = p["layers"]["q_proj"] if stage == 3 else o["m"]["layers"]["q_proj"]
        assert q.shape[d] * sharding == full["layers"]["q_proj"].shape[d]
        if stage == 3:      # the last rank holds the last slice
            assert torch.equal(q, full["layers"]["q_proj"].narrow(
                d, q.shape[d] * (sharding - 1), q.shape[d]))
    # stage 1 shards dim 0 of every moment (L, vocab, hidden), stage 3 a
    # hidden dimension of the params
    assert jax_raised == (hidden % sharding != 0
                          or (stage == 1 and layers % sharding != 0))


def test_shard_names_the_leaf(fake_rank):
    tcfg = tl.llama_tiny(vocab=96, hidden=64, layers=3, heads=4, kv_heads=4,
                         inter=128)
    full = tl.init_llama_params(tcfg, device="cpu")
    fake_rank(0, 2)
    with pytest.raises(ValueError, match=r"layers/\w+: dimension 0"):
        tl.shard_train_state(full, tl._adamw_init(full), tcfg,
                             tl.ParallelConfig(sharding=2, zero_stage=1))


_RENDEZVOUS_VARS = ("PADDLE_MASTER", "MASTER_ADDR", "MASTER_PORT",
                    "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "WORLD_SIZE",
                    "RANK")


@pytest.mark.parametrize("env, want", [
    ({"PADDLE_MASTER": "10.0.0.7:6170"}, "tcp://10.0.0.7:6170"),
    ({"PADDLE_MASTER": "10.0.0.7:6170", "MASTER_ADDR": "other"},
     "tcp://10.0.0.7:6170"),
    ({"MASTER_ADDR": "node0", "MASTER_PORT": "29500"}, "tcp://node0:29500"),
    # JAX's env reads MASTER_PORT with the same default
    ({"MASTER_ADDR": "node0"}, "tcp://node0:8475"),
    ({}, None)])
def test_rendezvous_address_follows_the_env(monkeypatch, env, want):
    from paddle_tpu_torch.distributed import env as denv
    for name in _RENDEZVOUS_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if want is None:
        with pytest.raises(ValueError, match="PADDLE_MASTER"):
            denv._init_method()
    else:
        assert denv._init_method() == want


def test_init_parallel_env_world_of_one_makes_no_group(monkeypatch):
    """As the JAX package's: one trainer and no store is a no-op; the rank
    and world queries then answer 0 and 1. A rank outside the world
    raises before any rendezvous."""
    from paddle_tpu_torch import distributed as pdist
    for name in _RENDEZVOUS_VARS:
        monkeypatch.delenv(name, raising=False)
    pdist.init_parallel_env("gloo")
    assert not pdist.is_initialized()
    assert (pdist.get_rank(), pdist.get_world_size()) == (0, 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        pdist.init_parallel_env("gloo")
    assert not pdist.is_initialized()
