"""Port parity: paddle_tpu_torch's Llama ``build_train_step`` under tensor
parallelism (mp), alone and composed with dp and ZeRO sharding, one gloo
process a rank on the CPU, against paddle_tpu's ``build_train_step`` on
its 8-device virtual CPU mesh.

The tiny fp32 Llama of ``tests/test_torch_dp_train.py`` (2 layers, GQA
4/2, head_dim 16, vocab 96; B 4, S 32; JAX's ``init_llama_params``
weights) takes three AdamW steps in JAX
and in the port, whose ranks load the same weights through
``shard_train_state`` and gather the result with ``gather_train_state``.
Both sides run ``use_flash=False`` with ``full`` remat. Configurations:
mp 2; mp 2 with tied embeddings; mp 2 with the rings on
(``PADDLE_TPU_TORCH_TP_OVERLAP=1`` in the ranks, ``PADDLE_TPU_TP_OVERLAP=1``
for JAX: at this batch both sides' fused FFN plans apply, and both
``tp.fused_ffn.plans`` counters tick); dp 2 x mp 2; mp 2 x sharding 2 at
stages 1, 2 and 3; mp 4 (heads 8 and KV heads 4, so both divide by 4).
Tolerances are that file's: every loss 1e-5 relative, every param 5e-6
absolute.

Also: every other remat policy at mp 2 is bitwise ``full``'s (a forward
all-reduce that reduced a kept product in place would sum it twice in
the recompute); the flash kernels' plain versions at mp 2 match the
port's single-process run; the mp ranks hold bitwise equal norms and the
dp replicas bitwise equal leaves; the collective bytes a step equal a
reckoning from the shapes; shard-then-gather gives every leaf back under
each mp layout; and the spawned ranks import no JAX.

One spawn of 2 ranks runs every world-2 configuration, one of 4 ranks
the world-4 ones, each joined within ``JOIN_S`` seconds.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import llama as jl
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.parallel import collective_matmul as jcm

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.testing import dist as td

B, S, STEPS, JOIN_S = 4, 32, 3, 150
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
# per-run LlamaConfig fields over CFG
CONFIGS = {"tied": dict(tie_word_embeddings=True),
           "mp4": dict(num_attention_heads=8, num_key_value_heads=4)}
OVERLAP = {"PADDLE_TPU_TORCH_TP_OVERLAP": "1"}
# name -> (world, ParallelConfig fields, config key or None, env)
RUNS = {
    "mp2": (2, dict(mp=2), None, {}),
    "mp2_tied": (2, dict(mp=2), "tied", {}),
    "mp2_overlap": (2, dict(mp=2), None, OVERLAP),
    "dp2_mp2": (4, dict(dp=2, mp=2), None, {}),
    "mp2_sh2_stage1": (4, dict(mp=2, sharding=2, zero_stage=1), None, {}),
    "mp2_sh2_stage2": (4, dict(mp=2, sharding=2, zero_stage=2), None, {}),
    "mp2_sh2_stage3": (4, dict(mp=2, sharding=2, zero_stage=3), None, {}),
    "mp4": (4, dict(mp=4), "mp4", {}),
}
POLICY_RUNS = {f"mp2_{p}": (2, dict(mp=2, remat_policy=p), None, {})
               for p in ("dots", "save_attn", "save_mlp", "offload_attn")}
FLASH_RUNS = {"mp2_flash": (2, dict(mp=2), None, {})}
ALL_RUNS = {**RUNS, **POLICY_RUNS, **FLASH_RUNS}
ROUNDTRIP = {2: {"mp2": dict(mp=2)},
             4: {"mp4": dict(mp=4), "dp2_mp2": dict(dp=2, mp=2),
                 **{f"mp2_sh2_stage{z}": dict(mp=2, sharding=2, zero_stage=z)
                    for z in (1, 2, 3)}}}


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


def _cfg_kw(key):
    return {**CFG, **CONFIGS.get(key, {})}


@pytest.fixture(scope="module")
def weights():
    """{config key: JAX's seeded params as numpy}."""
    return {key: jax.tree_util.tree_map(np.asarray, jl.init_llama_params(
        jl.LlamaConfig(**_cfg_kw(key), dtype=jax.numpy.float32), seed=0))
        for key in (None, "tied", "mp4")}


@pytest.fixture(scope="module")
def jax_runs(weights):
    ids, labels = _batches()
    out = {}
    for name, (world, kw, key, env) in RUNS.items():
        if name.endswith("stage2"):     # JAX's stages 1 and 2 are one
            out[name] = out[name[:-1] + "1"]    # program
            continue
        jcfg = jl.LlamaConfig(**_cfg_kw(key), dtype=jax.numpy.float32)
        par = jl.ParallelConfig(**kw, use_flash=False, remat=True)
        mesh = jl.make_mesh(par, jax.devices("cpu")[:world])
        mp = pytest.MonkeyPatch()
        if env:
            mp.setenv("PADDLE_TPU_TP_OVERLAP", "1")
        jtrace.reset_counters()
        jcm.clear_plan_cache()
        try:
            step, p, o = jl.build_train_step(jcfg, par, mesh=mesh)
            p = jax.tree_util.tree_map(lambda a, ref: jax.device_put(
                a, ref.sharding), weights[key], p)
            losses = []
            for i in range(STEPS):
                p, o, loss = step(p, o, ids[i], labels[i])
                losses.append(float(loss))
        finally:
            mp.undo()
            jcm.clear_plan_cache()
        out[name] = (losses, _flat(jax.tree_util.tree_map(np.asarray, p)),
                     jtrace.counters().get("tp.fused_ffn.plans", 0))
    return out


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """{world: (every rank's report, the directory of rank 0's npz)}."""
    out = {}
    ids, labels = _batches()
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        np.savez(tmp / "batches.npz", ids=ids, labels=labels)
        paths = {}
        for key, tree in weights.items():
            paths[key] = str(tmp / f"weights_{key}.npz")
            np.savez(paths[key], **_flat(tree))
        runs = []
        for name, (w, kw, key, env) in ALL_RUNS.items():
            if w != world:
                continue
            runs.append(dict(
                name=name, env=env, config=CONFIGS.get(key, {}),
                weights=paths[key], parallel=dict(
                    kw, use_flash=None if name.endswith("_flash") else False)))
        job = dict(config=dict(CFG, dtype="float32"), weights=paths[None],
                   batches=str(tmp / "batches.npz"), out=str(tmp), runs=runs,
                   roundtrip=ROUNDTRIP[world])
        out[world] = (td.spawn(td.train_job, world, (job,), timeout=JOIN_S,
                               store_dir=str(tmp)), tmp)
    return out


def _port(port_runs, name):
    world = ALL_RUNS[name][0]
    reports, tmp = port_runs[world]
    res = np.load(tmp / f"{name}.npz")
    params = {k[2:]: res[k] for k in res.files if k.startswith("p:")}
    return reports, list(res["losses"]), params


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax_and_agree_across_ranks(jax_runs, port_runs, name):
    reports, losses, _ = _port(port_runs, name)
    for r in reports:           # the same float on every rank
        assert r["runs"][name]["losses"] == losses
    np.testing.assert_allclose(losses, jax_runs[name][0], rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_params_match_jax(jax_runs, port_runs, name):
    _, _, params = _port(port_runs, name)
    want = jax_runs[name][1]
    assert set(params) == set(want)
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=5e-6, rtol=0,
                                   err_msg=k)


def test_overlap_runs_the_fused_ffn_rings_on_both_sides(jax_runs,
                                                        port_runs):
    """The fused FFN plan applied on both sides (one plan each: the
    port's memoised per rank, JAX's traced once), and the port's down
    product rode point-to-point hops in place of its all-reduce."""
    assert jax_runs["mp2_overlap"][2] == 1
    assert jax_runs["mp2"][2] == 0
    for r in port_runs[2][0]:
        on = r["runs"]["mp2_overlap"]["counters"]
        off = r["runs"]["mp2"]["counters"]
        assert on["tp.fused_ffn.plans"] == 1 and "tp.fused_ffn.plans" \
            not in off
        assert on["comm.ppermute.mp.calls"] > 0
        assert "comm.ppermute.mp.calls" not in off


def _layers_bytes(b_rows, itemsize=4):
    """[rows, S, H] activation bytes."""
    return b_rows * S * CFG["hidden_size"] * itemsize


@pytest.mark.parametrize("name", ["mp2", "mp2_overlap", "dp2_mp2", "mp4"])
def test_mp_collective_bytes_equal_the_reckoning(port_runs, name):
    """A step's mp collectives, from the shapes: one [b, S, H] all-reduce
    for the embedding and one for lm_head's input gradient; per layer two
    forward (o_proj, down_proj), one in the full remat's recompute (it
    stops after the last saved tensor, before down_proj's all-reduce) and
    two backward (the gradients entering q/k/v and gate/up); the cross
    entropy's three [b, S] f32 reductions. With the rings the down_proj
    all-reduce is 2 (mp - 1) hops of [b S / mp, H] forward and again in
    the recompute. b is the rank's rows."""
    world, kw, _, env = ALL_RUNS[name]
    mp = kw["mp"]
    b = B // kw.get("dp", 1)
    L = CFG["num_hidden_layers"]
    act = _layers_bytes(b)
    calls = 2 + (4 if env else 5) * L
    want = {"all_reduce.mp.bytes": calls * act + 3 * b * S * 4,
            "all_reduce.mp.calls": calls + 3}
    if env:
        hops = 2 * 2 * (mp - 1) * L
        want["ppermute.mp.calls"] = hops
        want["ppermute.mp.bytes"] = hops * act // mp
    for r in port_runs[world][0]:
        got = {k[len("comm."):]: v / STEPS
               for k, v in r["runs"][name]["counters"].items()
               if k.startswith("comm.") and ".mp." in k}
        assert got == want, (name, got, want)


@pytest.mark.parametrize("name", list(POLICY_RUNS))
def test_remat_policies_are_bitwise_full_at_mp2(port_runs, name):
    _, l_full, p_full = _port(port_runs, "mp2")
    _, losses, params = _port(port_runs, name)
    assert losses == l_full
    for k in p_full:
        np.testing.assert_array_equal(params[k], p_full[k], err_msg=k)


@pytest.fixture(scope="module")
def single_flash(weights):
    """The port's own single-process run with the flash plain versions."""
    ids, labels = _batches()
    cfg = tl.LlamaConfig(**CFG, dtype=torch.float32)
    step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(), device="cpu")
    p = tl.params_from_numpy(weights[None], "cpu")
    o = tl._adamw_init(p)
    losses = []
    for i in range(STEPS):
        p, o, loss = step(p, o, ids[i], labels[i])
        losses.append(float(loss))
    return losses, td.flat_tree(p)


def test_flash_at_mp2_matches_the_single_process_run(single_flash,
                                                     port_runs):
    _, losses, params = _port(port_runs, "mp2_flash")
    np.testing.assert_allclose(losses, single_flash[0], rtol=1e-5)
    for k, want in single_flash[1].items():
        np.testing.assert_allclose(params[k], want, atol=5e-6, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(ALL_RUNS))
def test_norms_agree_across_mp_and_replicas_across_dp(port_runs, name):
    """Every rank holds bitwise the same norms (their gradients are equal
    on the mp ranks after ``copy_to_mp``'s backward); the ranks of one mp
    coordinate and sharding coordinate hold the same bits of every leaf
    (dp replicas), except stage 3's other shards."""
    reports, _, _ = _port(port_runs, name)
    runs = [r["runs"][name] for r in reports]
    kw = ALL_RUNS[name][1]
    stage3 = kw.get("sharding", 1) > 1 and kw.get("zero_stage") == 3
    for a in runs:
        for b in runs:
            same = a["coord"][4] == b["coord"][4] and (
                a["coord"][2] == b["coord"][2] or not stage3)
            for leaf in a["crc"]:
                if same or "norm" in leaf:
                    assert a["crc"][leaf] == b["crc"][leaf], (leaf, a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_mp_groups_sit_where_jax_puts_their_devices(port_runs, world):
    reports, _ = port_runs[world]
    for name, (w, kw, _, _) in RUNS.items():
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
            assert run["mp"]["group"] == pos[where[:4]].tolist()
            assert run["mp"]["rank"] == (where[4], kw["mp"])
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


def test_mp4_config_divides_and_the_default_does_not():
    """The mp-4 run needs its own heads: the tiny config's 2 KV heads do
    not divide over 4 ranks, and the port refuses it."""
    base = tl.LlamaConfig(**CFG, dtype=torch.float32)
    with pytest.raises(ValueError, match="num_key_value_heads"):
        tl.check_mp_heads(base, tl.ParallelConfig(mp=4))
    tl.check_mp_heads(dataclasses.replace(base, **CONFIGS["mp4"]),
                      tl.ParallelConfig(mp=4))
