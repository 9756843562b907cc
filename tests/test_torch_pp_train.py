"""Port parity: paddle_tpu_torch's Llama ``build_train_step`` under
pipeline parallelism (pp), alone and composed with dp, mp and ZeRO
sharding, one gloo process a rank on the CPU, against paddle_tpu's
``build_train_step`` on its 8-device virtual CPU mesh (JAX's
``_build_pp_train_step``).

A tiny fp32 Llama (4 layers, so that pp 2 and 4 divide them; GQA 4/2,
head_dim 16, vocab 96; B 4, S 32 with masked labels; JAX's
``init_llama_params`` weights) takes three AdamW steps in JAX and in the
port, whose ranks load the same weights through ``shard_train_state``
and gather the result with ``gather_train_state`` (JAX's [S, L/S, ...]
layer layout). Both sides run ``use_flash=False`` with ``full`` remat.
Configurations: pp 2 (M 4) with the overlapped schedule off and on, and
under the ``dots`` policy; pp 4 (M 4, one layer a stage); dp 2 x pp 2, pp
2 x mp 2, pp 2 x sharding 2 at ZeRO stages 1 and 3 (M 2 where a rank
holds 2 rows). Tolerances are ``test_torch_dp_train.py``'s: every loss
1e-5 relative, every param 5e-6 absolute.

Also, before any update: each run's gradients, gathered, within 1e-5 of
each leaf's largest element of ``jax.grad`` of JAX's single-device
``llama_loss`` on the same weights and first batch (Adam's first step
moves each weight by about lr times its gradient's sign, so a gradient
summed twice or off by 1/S would pass the checks above), and the embed,
final_norm and lm_head gradients bitwise equal on every pp rank. The
overlapped run is bitwise the blocking one; the pp groups and the dp x
sharding planes sit where JAX puts their devices; each rank's hops a
step equal 2T of a microbatch's bytes; shard-then-gather gives every
leaf back; the spawned ranks import no JAX.

One spawn of 2 ranks runs every world-2 configuration, one of 4 the
world-4 ones, each joined within ``JOIN_S`` seconds.
"""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import llama as jl

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.testing import dist as td

B, S, STEPS, JOIN_S = 4, 32, 3, 150
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
# name -> (world, ParallelConfig fields)
RUNS = {
    "pp2": (2, dict(pp=2, microbatches=4)),
    "pp2_overlap": (2, dict(pp=2, microbatches=4, overlap_p2p=True)),
    "pp2_dots": (2, dict(pp=2, microbatches=4, remat_policy="dots")),
    "pp4": (4, dict(pp=4, microbatches=4)),
    "dp2_pp2": (4, dict(dp=2, pp=2, microbatches=2)),
    "pp2_mp2": (4, dict(pp=2, mp=2, microbatches=4)),
    "pp2_sh2_stage1": (4, dict(pp=2, sharding=2, zero_stage=1,
                               microbatches=2)),
    "pp2_sh2_stage3": (4, dict(pp=2, sharding=2, zero_stage=3,
                               microbatches=2)),
}
ROUNDTRIP = {2: {"pp2": dict(pp=2)},
             4: {"pp4": dict(pp=4), "dp2_pp2": dict(dp=2, pp=2),
                 "pp2_mp2": dict(pp=2, mp=2),
                 "pp2_sh2_stage3": dict(pp=2, sharding=2, zero_stage=3)}}
HEAD = ("embed", "final_norm", "lm_head")


def _batches():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, CFG["vocab_size"], size=(STEPS, B, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :27] = -100
    labels[:, 1, ::2] = -100
    return ids, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jcfg():
    return jl.LlamaConfig(**CFG, dtype=jax.numpy.float32)


@pytest.fixture(scope="module")
def weights():
    return jax.tree_util.tree_map(np.asarray,
                                  jl.init_llama_params(_jcfg(), seed=0))


@pytest.fixture(scope="module")
def jax_runs(weights):
    """{run: (losses, params flat)} of JAX's pp mesh step."""
    ids, labels = _batches()
    out = {}
    for name, (world, kw) in RUNS.items():
        par = jl.ParallelConfig(**kw, use_flash=False, remat=True)
        mesh = jl.make_mesh(par, jax.devices("cpu")[:world])
        step, p, o = jl.build_train_step(_jcfg(), par, mesh=mesh)
        staged = dict(weights, layers=jax.tree_util.tree_map(
            lambda a: a.reshape((kw["pp"], -1) + a.shape[1:]),
            weights["layers"]))
        p = jax.tree_util.tree_map(lambda a, ref: jax.device_put(
            a, ref.sharding), staged, p)
        losses = []
        for i in range(STEPS):
            p, o, loss = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
        out[name] = (losses, _flat(jax.tree_util.tree_map(np.asarray, p)))
    return out


@pytest.fixture(scope="module")
def jax_grads(weights):
    """jax.grad of the single-device llama_loss on the first batch."""
    ids, labels = _batches()
    par = jl.ParallelConfig(use_flash=False)
    grads = jax.jit(jax.grad(lambda p: jl.llama_loss(
        p, ids[0], labels[0], _jcfg(), par, use_flash=False)))(
            jax.tree_util.tree_map(jax.numpy.asarray, weights))
    return _flat(jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """{world: (every rank's report, the directory of rank 0's npz)}."""
    out = {}
    ids, labels = _batches()
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        np.savez(tmp / "batches.npz", ids=ids, labels=labels)
        np.savez(tmp / "weights.npz", **_flat(weights))
        runs = [dict(name=name, grads=True,
                     parallel=dict(kw, use_flash=False))
                for name, (w, kw) in RUNS.items() if w == world]
        job = dict(config=dict(CFG, dtype="float32"),
                   weights=str(tmp / "weights.npz"),
                   batches=str(tmp / "batches.npz"), out=str(tmp),
                   runs=runs, roundtrip=ROUNDTRIP[world])
        out[world] = (td.spawn(td.train_job, world, (job,), timeout=JOIN_S,
                               store_dir=str(tmp)), tmp)
    return out


def _port(port_runs, name):
    reports, tmp = port_runs[RUNS[name][0]]
    res = np.load(tmp / f"{name}.npz")
    params = {k[2:]: res[k] for k in res.files if k.startswith("p:")}
    grads = {k[2:]: res[k] for k in res.files if k.startswith("g:")}
    return [r["runs"][name] for r in reports], list(res["losses"]), params, \
        grads


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax_and_agree_across_ranks(jax_runs, port_runs, name):
    ranks, losses, _, _ = _port(port_runs, name)
    for r in ranks:             # the same float on every rank
        assert r["losses"] == losses
    np.testing.assert_allclose(losses, jax_runs[name][0], rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_params_match_jax(jax_runs, port_runs, name):
    _, _, params, _ = _port(port_runs, name)
    want = jax_runs[name][1]
    assert set(params) == set(want)
    for k in want:
        assert params[k].shape == want[k].shape, k
        np.testing.assert_allclose(params[k], want[k], atol=5e-6, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_grads_match_single_device_jax(jax_grads, port_runs, name):
    """Before AdamW: every gathered gradient within 1e-5 of its leaf's
    largest element of jax.grad of the single-device loss."""
    _, _, _, grads = _port(port_runs, name)
    assert set(grads) == set(jax_grads)
    for k, want in jax_grads.items():
        got = grads[k].reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_head_grads_and_replicas_agree_across_ranks(port_runs, name):
    """Embed, final_norm and lm_head gradients are bitwise equal on every
    pp rank (of one mp and stage-3 sharding coordinate), and so are their
    params after the steps; the ranks of one stage and mp coordinate
    (dp and stage 1's sharding replicas) hold the same bits of every
    leaf, except stage 3's other shards."""
    ranks, _, _, _ = _port(port_runs, name)
    kw = RUNS[name][1]
    stage3 = kw.get("sharding", 1) > 1 and kw.get("zero_stage") == 3
    for a in ranks:
        for b in ranks:
            same_shard = a["coord"][4] == b["coord"][4] and (
                a["coord"][2] == b["coord"][2] or not stage3)
            if not same_shard:
                continue
            assert a["grad_crc"] == b["grad_crc"], (a["coord"], b["coord"])
            for leaf in a["crc"]:
                if leaf in HEAD or a["coord"][1] == b["coord"][1]:
                    assert a["crc"][leaf] == b["crc"][leaf], leaf


def test_overlap_is_bitwise_blocking(port_runs):
    ranks, losses, params, grads = _port(port_runs, "pp2")
    o_ranks, o_losses, o_params, o_grads = _port(port_runs, "pp2_overlap")
    assert losses == o_losses
    for k in params:
        np.testing.assert_array_equal(params[k], o_params[k], err_msg=k)
    for k in grads:
        np.testing.assert_array_equal(grads[k], o_grads[k], err_msg=k)
    for r, o in zip(ranks, o_ranks):
        assert r["counters"]["pp.overlap"] == 0
        assert o["counters"]["pp.overlap"] == 1


@pytest.mark.parametrize("name", list(RUNS))
def test_hops_a_step_equal_the_reckoning(port_runs, name):
    """Every rank makes T hops forward and T back a step (T = M + S - 1,
    M + 2(S - 1) overlapped), each a microbatch [b/M, S, H] in f32 (b the
    rank's rows); the pp counters are JAX's."""
    ranks, _, _, _ = _port(port_runs, name)
    kw = RUNS[name][1]
    pp, m = kw["pp"], max(kw["microbatches"], kw["pp"])
    ticks = m + (2 if kw.get("overlap_p2p") else 1) * (pp - 1)
    rows = B // (kw.get("dp", 1) * kw.get("sharding", 1))
    hop = rows // m * S * CFG["hidden_size"] * 4
    for r in ranks:
        c = r["counters"]
        assert (c["pp.stages"], c["pp.microbatches"], c["pp.ticks"]) == (
            pp, m, ticks)
        assert c["comm.ppermute.pp.calls"] == 2 * ticks * STEPS
        assert c["comm.ppermute.pp.bytes"] == 2 * ticks * hop * STEPS


@pytest.mark.parametrize("world", [2, 4])
def test_pp_groups_sit_where_jax_puts_their_devices(port_runs, world):
    reports, _ = port_runs[world]
    for name, (w, kw) in RUNS.items():
        if w != world:
            continue
        mesh = jl.make_mesh(jl.ParallelConfig(**kw),
                            jax.devices("cpu")[:world])
        pos = np.vectorize(lambda d: jax.devices("cpu").index(d))(
            mesh.devices)
        for rank, r in enumerate(reports):
            run = r["runs"][name]
            where = tuple(int(i) for i in np.argwhere(pos == rank)[0])
            assert tuple(run["coord"]) == where
            line = pos[where[0], :, where[2], where[3], where[4]].tolist()
            assert run["pp"]["group"] == run["pp"]["stage_ranks"] == line
            assert run["pp"]["stage"] == (where[1], kw["pp"])
            assert run["pp"]["first"] == (where[1] == 0)
            assert run["pp"]["last"] == (where[1] == kw["pp"] - 1)
            # the dp x sharding plane of this (pp, sep, mp) coordinate
            assert run["mp"]["data_group"] == pos[
                :, where[1], :, where[3], where[4]].reshape(-1).tolist()


@pytest.mark.parametrize("world", [2, 4])
def test_shard_then_gather_returns_the_full_trees_bitwise(port_runs, world):
    reports, _ = port_runs[world]
    for r in reports:
        assert r["roundtrip"].keys() == ROUNDTRIP[world].keys()
        assert all(r["roundtrip"].values()), r["roundtrip"]


def test_spawned_ranks_import_no_jax(port_runs):
    for world, (reports, _) in port_runs.items():
        for r in reports:
            assert r["jax_modules"] == [], (world, r["jax_modules"])


def test_specs_are_jax_s_under_pp():
    """The step's param and moment specs equal JAX's placements under pp
    (layers ("pp",) + spec, m and v by the param specs), and a layer count
    pp does not divide raises naming the config."""
    for kw in (dict(pp=2), dict(pp=2, mp=2), dict(pp=2, sharding=2,
                                                  zero_stage=1),
               dict(pp=2, sharding=2, zero_stage=3), dict(dp=2, pp=4)):
        jspecs = jl.param_pspecs(_jcfg(), jl.ParallelConfig(**kw))
        want = {k: ({n: ("pp",) + tuple(s) for n, s in v.items()}
                    if k == "layers" else tuple(v))
                for k, v in jspecs.items()}
        tcfg = tl.LlamaConfig(**CFG, dtype=torch.float32)
        pspecs, ospecs = tl.train_state_pspecs(tcfg, tl.ParallelConfig(**kw))
        assert pspecs == ospecs == want, kw
    with pytest.raises(ValueError, match=r"pp=3 needs num_hidden_layers "
                                         r"\(4\).*LlamaConfig\("):
        tl.check_pp_layers(tl.LlamaConfig(**CFG), tl.ParallelConfig(pp=3))
