"""Port parity: paddle_tpu_torch's Llama ``build_train_step`` under dp and
ZeRO sharding, one gloo process a rank on the CPU, against paddle_tpu's
``build_train_step`` on its 8-device virtual CPU mesh.

A tiny fp32 Llama (2 layers, GQA 4/2, head_dim 16, vocab 96; B 4, S 32)
with JAX's ``init_llama_params`` weights takes three AdamW steps in
JAX (its numpy weights placed with the shardings of the params its
``build_train_step`` returned) and in the port, whose ranks load the same
weights through ``shard_train_state`` and gather the result with
``gather_train_state``. Both sides run ``use_flash=False`` with ``full``
remat (stage 3 also ``dots``; the other policies at stage 3 are held
bitwise to stage 1's run). Configurations: dp 2; sharding 2 at
stages 1, 2 and 3 (world 2); dp 2 x sharding 2 at stages 1, 2 and 3
(world 4: stage 1's all-reduce over the whole world, stage 2's owners
summing over dp, stage 3's shards over dp). The
labels carry -100 unevenly across the ranks' rows, so the mean of
per-rank means would miss the global mean by far more than the
tolerance (``test_uneven_labels_separate_the_global_mean``).

Tolerances are ``tests/test_torch_train.py``'s: every loss 1e-5
relative, every param 5e-6 absolute. With the flash kernels' plain
versions (``use_flash`` None), dp 2 and stage 3 (worlds 2 and 4) are held
to the port's own single-process run at the same tolerances.

The ranks run ``paddle_tpu_torch.testing.dist.train_job`` (torch and the
port only), joined through a ``FileStore`` in ``tmp_path``; each spawn
has a time limit of ``JOIN_S`` seconds. One spawn of 2 ranks runs every
world-2 configuration, one of 4 ranks the world-4 ones.
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
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64)
# name -> (world, ParallelConfig fields); use_flash False unless *_flash
RUNS = {
    "dp2": (2, dict(dp=2)),
    "sh2_stage1": (2, dict(sharding=2, zero_stage=1)),
    "sh2_stage2": (2, dict(sharding=2, zero_stage=2)),
    "sh2_stage3": (2, dict(sharding=2, zero_stage=3)),
    "sh2_stage3_dots": (2, dict(sharding=2, zero_stage=3,
                                remat_policy="dots")),
    "dp2_sh2_stage1": (4, dict(dp=2, sharding=2, zero_stage=1)),
    "dp2_sh2_stage2": (4, dict(dp=2, sharding=2, zero_stage=2)),
    "dp2_sh2_stage3": (4, dict(dp=2, sharding=2, zero_stage=3)),
}
# the other remat policies at stage 3, held bitwise to stage 1's run: no
# policy keeps or replays the gathers' collectives
POLICY_RUNS = {f"sh2_stage3_{p}": (2, dict(sharding=2, zero_stage=3,
                                           remat_policy=p))
               for p in ("save_attn", "save_mlp", "offload_attn")}
FLASH_RUNS = {"dp2_flash": (2, dict(dp=2)),
              "sh2_stage3_flash": (2, dict(sharding=2, zero_stage=3)),
              "dp2_sh2_stage3_flash": (4, dict(dp=2, sharding=2,
                                               zero_stage=3))}

ALL_RUNS = {**RUNS, **POLICY_RUNS, **FLASH_RUNS}


def _batches():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, CFG["vocab_size"], size=(STEPS, B, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :27] = -100     # row 0 (rank 0's) keeps 4 of 32 labels
    labels[:, 1, ::2] = -100     # row 1 half
    return ids, labels


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.LlamaConfig(**CFG, dtype=jax.numpy.float32)
    return jcfg, jax.tree_util.tree_map(np.asarray,
                                        jl.init_llama_params(jcfg, seed=0))


@pytest.fixture(scope="module")
def jax_runs(weights):
    jcfg, np_params = weights
    ids, labels = _batches()
    out = {}
    for name, (world, kw) in RUNS.items():
        if name.endswith("stage2"):     # JAX's stages 1 and 2 are one
            out[name] = out[name[:-1] + "1"]    # program
            continue
        par = jl.ParallelConfig(**kw, use_flash=False, remat=True)
        mesh = jl.make_mesh(par, jax.devices("cpu")[:world])
        step, p, o = jl.build_train_step(jcfg, par, mesh=mesh)
        p = jax.tree_util.tree_map(lambda a, ref: jax.device_put(
            a, ref.sharding), np_params, p)
        losses = []
        for i in range(STEPS):
            p, o, loss = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
        out[name] = (losses, _flat(jax.tree_util.tree_map(np.asarray, p)))
    return out


def _spawn(tmp, world, runs, weights_path, extra=None):
    ids, labels = _batches()
    np.savez(tmp / "batches.npz", ids=ids, labels=labels)
    job = dict(config=dict(CFG, dtype="float32"), weights=str(weights_path),
               batches=str(tmp / "batches.npz"), out=str(tmp),
               runs=[dict(name=n, parallel=dict(
                   kw, use_flash=None if n.endswith("_flash") else False))
                   for n, (w, kw) in runs.items() if w == world],
               **(extra or {}))
    return td.spawn(td.train_job, world, (job,), timeout=JOIN_S,
                    store_dir=str(tmp))


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """{world: (every rank's report, the directory of rank 0's npz)}."""
    _, np_params = weights
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        wpath = tmp / "weights.npz"
        np.savez(wpath, **_flat(np_params))
        extra = {}
        if world == 2:
            (tmp / "ckpt").mkdir()
            extra = dict(checkpoint_dir=str(tmp / "ckpt"), roundtrip=True)
        out[world] = (_spawn(tmp, world, ALL_RUNS, wpath,
                             extra), tmp)
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


@pytest.mark.parametrize("name", list(ALL_RUNS))
def test_dp_replicas_stay_bitwise_equal(port_runs, name):
    """Ranks at the same sharding coordinate hold the same bits; with
    sharding above 1 and stage 3 the others hold other shards, whose
    replicated norms still agree."""
    reports, _, _ = _port(port_runs, name)
    runs = [r["runs"][name] for r in reports]
    kw = ALL_RUNS[name][1]
    stage3 = kw.get("sharding", 1) > 1 and kw.get("zero_stage") == 3
    for a in runs:
        for b in runs:
            same_shard = a["coord"][2] == b["coord"][2]
            for leaf in a["crc"]:
                if same_shard or not stage3 or "norm" in leaf:
                    assert a["crc"][leaf] == b["crc"][leaf], (leaf, a, b)


def test_stages_1_2_3_give_the_same_bits_on_two_ranks(port_runs):
    """Over two ranks a sum is one addition, so the all-reduce (stage 1),
    the reduce to the owner (stage 2) and the reduce-scatter (stage 3)
    give the same gradient bits, and the updates agree bitwise."""
    _, l1, p1 = _port(port_runs, "sh2_stage1")
    for name in ("sh2_stage2", "sh2_stage3", "sh2_stage3_dots",
                 *POLICY_RUNS):
        _, ln, pn = _port(port_runs, name)
        assert ln == l1, name
        for k in p1:
            np.testing.assert_array_equal(pn[k], p1[k], err_msg=(name, k))


@pytest.fixture(scope="module")
def single_flash(weights):
    """The port's own single-process run with the flash plain versions."""
    _, np_params = weights
    ids, labels = _batches()
    cfg = tl.LlamaConfig(**CFG, dtype=torch.float32)
    step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(), device="cpu")
    p = tl.params_from_numpy(np_params, "cpu")
    o = tl._adamw_init(p)
    losses = []
    for i in range(STEPS):
        p, o, loss = step(p, o, ids[i], labels[i])
        losses.append(float(loss))
    return losses, td.flat_tree(p)


@pytest.mark.parametrize("name", list(FLASH_RUNS))
def test_flash_runs_match_the_single_process_run(single_flash, port_runs,
                                                 name):
    reports, losses, params = _port(port_runs, name)
    np.testing.assert_allclose(losses, single_flash[0], rtol=1e-5)
    for k, want in single_flash[1].items():
        np.testing.assert_allclose(params[k], want, atol=5e-6, rtol=0,
                                   err_msg=k)


def test_uneven_labels_separate_the_global_mean(weights):
    """The mean of the ranks' own means lies far outside the loss
    tolerance from the global mean on these labels, so a step that
    averaged per-rank means would fail the loss checks above."""
    _, np_params = weights
    ids, labels = _batches()
    cfg = tl.LlamaConfig(**CFG, dtype=torch.float32)
    p = tl.params_from_numpy(np_params, "cpu")
    par = tl.ParallelConfig(use_flash=False)

    def loss(rows):
        return float(tl.llama_loss(p, torch.from_numpy(ids[0, rows]),
                                   torch.from_numpy(labels[0, rows]), cfg,
                                   par))
    whole = loss(slice(0, B))
    for world in (2, 4):
        n = B // world
        means = np.mean([loss(slice(r * n, (r + 1) * n))
                         for r in range(world)])
        assert abs(means - whole) > 100 * 1e-5 * abs(whole), (world, means,
                                                              whole)


def test_spawned_ranks_import_no_jax(port_runs):
    for world, (reports, _) in port_runs.items():
        for r in reports:
            assert r["jax_modules"] == [], (world, r["jax_modules"])


def test_four_ranks_sit_where_jax_puts_their_devices(port_runs):
    """Rank r's coordinates and its dp and sharding lines are device r's
    position and lines in JAX's make_mesh of dp 2 x sharding 2."""
    mesh = jl.make_mesh(jl.ParallelConfig(dp=2, sharding=2),
                        jax.devices("cpu")[:4])
    pos = np.vectorize(lambda d: jax.devices("cpu").index(d))(mesh.devices)
    reports, _ = port_runs[4]
    for rank, r in enumerate(reports):
        run = r["runs"]["dp2_sh2_stage3"]
        where = tuple(int(i) for i in np.argwhere(pos == rank)[0])
        assert tuple(run["coord"]) == where
        dp_line = pos[:, where[1], where[2], where[3], where[4]].tolist()
        sh_line = pos[where[0], where[1], :, where[3], where[4]].tolist()
        assert run["groups"] == {"dp": dp_line, "sharding": sh_line}
        # the real index along each axis (JAX's single controller says 0)
        assert run["axis_ranks"] == {"dp": (where[0], 2),
                                     "sharding": (where[2], 2)}


def test_shard_then_gather_returns_the_full_trees_bitwise(port_runs):
    reports, _ = port_runs[2]
    for r in reports:
        assert r["roundtrip"] and all(r["roundtrip"].values()), r["roundtrip"]


def test_checkpoint_round_trip_over_two_ranks(port_runs):
    """A CheckpointManager save over the two ranks (the weights and a
    random AdamW state, each rank its shards under dp 2 and under
    sharding 2 at stage 3) restores bitwise into a fresh train step's
    state under either layout; the coordinator published each step."""
    reports, _ = port_runs[2]
    for r in reports:
        ck = r["checkpoint"]
        assert ck["latest"] == {"dp": 5, "stage3": 5}, ck
        for name in ("dp", "stage3"):
            assert "COMMIT.json" in ck["files"][name], ck
        for pair in ("dp->dp", "dp->stage3", "stage3->dp",
                     "stage3->stage3"):
            assert ck[pair] is True, (pair, ck)
