"""Port parity: the tensor-parallel (mp) layout of paddle_tpu_torch's Llama
train step against paddle_tpu's, on the CPU, in one process.

- ``param_pspecs`` and ``opt_state_pspecs`` equal JAX's, each JAX
  ``PartitionSpec`` read as a tuple, over dp in {1, 2}, mp in {1, 2, 4},
  sharding in {1, 2}, ZeRO stages 1-3, tied and untied embeddings.
- The mp rank and world queries and the mp and dp x sharding lines of
  ``HybridCommunicateGroup`` equal the device positions of JAX's
  ``make_mesh`` over its 8 virtual CPU devices (device r is rank r), and
  JAX's mp world size (its rank query answers 0: the port's answers the
  real coordinate).
- ``shard_train_state`` gives rank r the shard of each param and moment
  that JAX's ``device_put`` with the leaf's ``NamedSharding`` places on
  device r, bitwise, under mp alone and composed with dp and sharding.
- A head count that mp does not divide raises ValueError naming the
  config, where JAX's GSPMD splits through a head.
- Every plan's None-or-applies decision, and ``resolve_chunks``, equal
  JAX's on the same shapes, degrees and knobs.

The multi-rank cases run under torch's in-process ``fake`` process-group
backend (no communication), one rank at a time.
"""
import dataclasses

import numpy as np
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.distributed.fleet import topology as jtopo
from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import collective_matmul as jcm

from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.distributed.fleet import HybridCommunicateGroup
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.parallel import collective_matmul as tcm


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("sharding", [1, 2])
@pytest.mark.parametrize("mp", [1, 2, 4])
@pytest.mark.parametrize("dp", [1, 2])
def test_pspecs_match_jax(dp, mp, sharding, stage, tied):
    jcfg = dataclasses.replace(jl.llama_tiny(), tie_word_embeddings=tied)
    tcfg = dataclasses.replace(tl.llama_tiny(), tie_word_embeddings=tied)
    kw = dict(dp=dp, mp=mp, sharding=sharding, zero_stage=stage)
    jpar, tpar = jl.ParallelConfig(**kw), tl.ParallelConfig(**kw)
    jspecs = jl.param_pspecs(jcfg, jpar)
    tspecs = tl.param_pspecs(tcfg, tpar)
    assert tspecs == _tuples(jspecs)
    assert tl.opt_state_pspecs(tcfg, tpar, tspecs) == _tuples(
        jl.opt_state_pspecs(jcfg, jpar, jspecs))


@pytest.fixture
def fake_rank():
    """Run under a fake process group of ``world`` ranks as ``rank``."""
    def init(rank, world):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _positions(kw):
    devs = jax.devices("cpu")
    where = {d.id: i for i, d in enumerate(devs)}
    mesh = jl.make_mesh(jl.ParallelConfig(**kw), devs)
    return mesh, np.vectorize(lambda d: where[d.id])(mesh.devices)


MESHES = [dict(mp=2), dict(mp=4), dict(dp=2, mp=2), dict(sharding=2, mp=2),
          dict(dp=2, sharding=2, mp=2), dict(dp=2, mp=4),
          dict(sharding=4, mp=2)]


@pytest.mark.parametrize("kw", MESHES, ids=lambda kw: "_".join(
    f"{k}{v}" for k, v in kw.items()))
def test_mp_queries_and_lines_sit_where_jax_puts_their_devices(fake_rank,
                                                               kw):
    _, pos = _positions(kw)
    world = pos.size
    jhcg = jtopo.HybridCommunicateGroup(
        dp_degree=kw.get("dp", 1), sharding_degree=kw.get("sharding", 1),
        mp_degree=kw["mp"], devices=jax.devices("cpu")[:world])
    for rank in range(world):
        fake_rank(rank, world)
        hcg = HybridCommunicateGroup(dp_degree=kw.get("dp", 1),
                                     sharding_degree=kw.get("sharding", 1),
                                     mp_degree=kw["mp"])
        where = tuple(int(i) for i in np.argwhere(pos == rank)[0])
        assert hcg.get_model_parallel_world_size() == \
            jhcg.get_model_parallel_world_size() == kw["mp"]
        # the real index along mp (JAX's single controller says 0)
        assert jhcg.get_model_parallel_rank() == 0
        assert hcg.get_model_parallel_rank() == where[4]
        mp_line = pos[where[:4]].tolist()
        assert hcg.get_model_parallel_group().ranks == mp_line
        plane = pos[:, where[1], :, where[3], where[4]]
        data = hcg.get_data_sharding_group()
        if kw.get("dp", 1) > 1 and kw.get("sharding", 1) > 1:
            assert data.axis_name == "dp,sharding"
            assert data.ranks == plane.reshape(-1).tolist()
        else:
            assert data.ranks == plane.reshape(-1).tolist()
            # the one axis above 1, or dp's group of this rank alone
            assert data.axis_name == ("sharding" if kw.get("sharding", 1)
                                      > 1 else "dp")


LAYOUTS = {
    "mp2": dict(mp=2), "mp4": dict(mp=4), "mp2_tied": dict(mp=2),
    "dp2_mp2": dict(dp=2, mp=2),
    **{f"mp2_sh2_stage{z}": dict(mp=2, sharding=2, zero_stage=z)
       for z in (1, 2, 3)},
    "mp4_sh2_stage3": dict(mp=4, sharding=2, zero_stage=3),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shards_are_jax_device_shards(fake_rank, name):
    """Rank r's shard of every param and AdamW moment is bitwise the shard
    JAX places on device r."""
    kw = LAYOUTS[name]
    cfg_kw = dict(vocab=96, hidden=64, layers=2, heads=8, kv_heads=4,
                  inter=128)
    jcfg = dataclasses.replace(jl.llama_tiny(**cfg_kw),
                               tie_word_embeddings=name.endswith("tied"))
    tcfg = dataclasses.replace(tl.llama_tiny(**cfg_kw),
                               tie_word_embeddings=name.endswith("tied"))
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jl.init_llama_params(jcfg, 0))
    rng = np.random.RandomState(1)
    np_m = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), np_params)
    mesh, pos = _positions(kw)
    jpar, tpar = jl.ParallelConfig(**kw), tl.ParallelConfig(**kw)
    pspecs = jl.param_pspecs(jcfg, jpar)
    ospecs = jl.opt_state_pspecs(jcfg, jpar, pspecs)

    def placed(tree, specs):
        return _flat(jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree,
            specs, is_leaf=lambda x: isinstance(x, P)))
    jp, jm = placed(np_params, pspecs), placed(np_m, ospecs)
    full = tl.params_from_numpy(np_params, "cpu")
    opt = {"m": tl.params_from_numpy(np_m, "cpu"),
           "v": tl.params_from_numpy(np_m, "cpu"), "t": None}
    devs = list(mesh.devices.reshape(-1))
    for rank in range(pos.size):
        fake_rank(rank, pos.size)
        p, o = tl.shard_train_state(full, opt, tcfg, tpar)
        dev = devs[list(pos.reshape(-1)).index(rank)]
        for got, want in ((_flat(p), jp), (_flat(o["m"]), jm)):
            assert got.keys() == want.keys()
            for k, arr in want.items():
                (shard,) = [s for s in arr.addressable_shards
                            if s.device == dev]
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(shard.data),
                                              err_msg=(name, rank, k))


@pytest.mark.parametrize("heads,kv,mp", [(4, 2, 4), (6, 3, 4), (4, 4, 8),
                                         (6, 2, 4)])
def test_heads_that_mp_does_not_divide_raise_naming_the_config(heads, kv,
                                                               mp):
    """A rank holds whole heads: NH and NKV must divide by mp. JAX's GSPMD
    builds the step and splits k/v columns through a head instead."""
    kw = dict(vocab=96, hidden=96 if heads % 3 == 0 else 64, layers=2,
              heads=heads, kv_heads=kv, inter=128)
    jpar = jl.ParallelConfig(mp=mp, use_flash=False)
    jl.build_train_step(jl.llama_tiny(**kw), jpar,
                        mesh=jl.make_mesh(jpar, jax.devices("cpu")))
    with pytest.raises(ValueError, match=r"mp=\d+ needs num_attention_heads"
                                         r".*LlamaConfig\("):
        tl.build_train_step(tl.llama_tiny(**kw), tl.ParallelConfig(mp=mp),
                            device="cpu")


@pytest.mark.parametrize("kw,what", [
    (dict(pp=2, mp=2, sep=2), "item 9"), (dict(sep=2, mp=2), "item 9"),
    (dict(mp=2, overlap_p2p=True), "overlap_p2p")])
def test_pp_and_sep_still_raise_beside_mp(kw, what):
    with pytest.raises(ValueError, match=what):
        tl.check_ported(tl.ParallelConfig(**kw))


# ---------------------------------------------------------------------------
# plans: the None-or-applies decision against JAX's
# ---------------------------------------------------------------------------

def _jax_mesh(dp, n):
    return Mesh(np.array(jax.devices("cpu")[:dp * n]).reshape(dp, n),
                ("dp", "mp"))


def _group(n):
    return Group("mp", n, 0, list(range(n)))


# (x or ids or logits shape, weight shapes) per plan; each runs at every
# (dp, mp) and MIN_CHUNK below
ROW = [((4, 32, 64), (64, 96)), ((2, 16, 64), (64, 48)), ((4, 32, 62),
                                                         (62, 96)),
       ((3, 7, 64), (64, 96)), ((128, 256), (256, 64))]
COL = [((4, 32, 64), (64, 256)), ((4, 32, 64), (64, 96)),
       ((4, 32, 64), (64, 100)), ((2, 16, 64), (64, 512))]
FFN = [((4, 32, 64), (64, 256), (256, 64)), ((4, 32, 64), (64, 96),
                                             (96, 64)),
       ((4, 32, 64), (64, 256), (128, 64)), ((1, 64, 32), (32, 512),
                                             (512, 32))]
EMB = [((4, 32), (96, 64)), ((4, 32), (98, 64)), ((1, 8), (96, 64)),
       ((8, 64), (512, 16))]
CE = [((4, 32, 256),), ((4, 32, 96),), ((4, 32, 98),), ((1, 1, 512),)]
PLANS = {"row": ("plan_row_parallel", ROW),
         "column": ("plan_column_parallel", COL),
         "fused_ffn": ("plan_fused_ffn", FFN),
         "vocab_embed": ("plan_vocab_parallel_embedding", EMB),
         "parallel_ce": ("plan_parallel_cross_entropy", CE)}


@pytest.mark.parametrize("min_chunk", ["64", "16", "4"])
@pytest.mark.parametrize("dp,n", [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("plan", list(PLANS))
def test_plans_apply_where_jax_applies(monkeypatch, plan, dp, n, min_chunk):
    monkeypatch.setenv(jcm.ENV_MIN_CHUNK, min_chunk)
    monkeypatch.setenv(tcm.ENV_MIN_CHUNK, min_chunk)
    fn, cases = PLANS[plan]
    mesh, group = _jax_mesh(dp, n), _group(n)
    applied = 0
    for shapes in cases:
        want = getattr(jcm, fn)(*shapes, mesh) is not None
        got = getattr(tcm, fn)(*shapes, group, batch_degree=dp)
        assert (got is not None) == want, (fn, shapes, dp, n, min_chunk)
        applied += want
    if n == 1:
        assert applied == 0


@pytest.mark.parametrize("chunks", [None, "", "auto", "2", "3", "16"])
@pytest.mark.parametrize("min_chunk", [None, "64", "10"])
def test_resolve_chunks_matches_jax(monkeypatch, chunks, min_chunk):
    for env, value in ((jcm.ENV_CHUNKS, chunks), (tcm.ENV_CHUNKS, chunks),
                       (jcm.ENV_MIN_CHUNK, min_chunk),
                       (tcm.ENV_MIN_CHUNK, min_chunk)):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
    for n in (1, 2, 4, 8):
        for rows in (1, 2, 6, 48, 64, 96, 256, 1000, 4096):
            assert tcm.resolve_chunks(n, rows) == jcm.resolve_chunks(
                n, rows), (n, rows)


def test_plans_are_memoised_and_counted(monkeypatch):
    """A plan is built once per arguments and knobs, and counts
    ``tp.<plan>.plans`` when built, as JAX's."""
    from paddle_tpu_torch.observability import trace
    monkeypatch.setenv(tcm.ENV_MIN_CHUNK, "16")
    trace.reset_counters()
    group = _group(2)
    tcm.clear_plan_cache()
    try:
        a = tcm.plan_fused_ffn((4, 32, 64), (64, 256), (256, 64), group,
                               n_cols=2, activation=tcm.swiglu)
        b = tcm.plan_fused_ffn((4, 32, 64), (64, 256), (256, 64), group,
                               n_cols=2, activation=tcm.swiglu)
        assert a is b and trace.counters()["tp.fused_ffn.plans"] == 1
        monkeypatch.setenv(tcm.ENV_MIN_CHUNK, "8")
        assert tcm.plan_fused_ffn((4, 32, 64), (64, 256), (256, 64), group,
                                  n_cols=2, activation=tcm.swiglu) is not a
        assert trace.counters()["tp.fused_ffn.plans"] == 2
    finally:
        tcm.clear_plan_cache()
