"""Port parity: elastic resume under pipeline parallelism. A Llama train
state saved by ``CheckpointManager`` over pp 2 ranks (one gloo process a
rank on the CPU) restores under dp 2 x pp 2 on 4 ranks, each rank reading
only its slice of the [S, L/S, ...] layer leaves, against paddle_tpu's
``build_train_step`` and ``CheckpointManager`` on its virtual CPU mesh.

``llama_tiny(vocab=128, hidden=32, layers=4, heads=4, kv_heads=4,
inter=64, seq=64)`` (four layers, so that pp 2 and 4 divide them), four
``RandomState(5)`` batches of (8, 32), labels rolled by one, lr 1e-3,
``use_flash=False``, no remat, 4 microbatches; the port's ranks start
from JAX's initial weights. pp 2 trains steps 1-2 and checkpoints step 2;
a fresh ``restore_train_step`` under dp 2 x pp 2 checks that every
leaf of every rank is bitwise its slice of the saved leaves, then runs
steps 3-4, within ``rtol=1e-4, atol=1e-6`` of JAX's elastic tail (its
manager saving at the pp 2 mesh, restoring at the dp 2 x pp 2 mesh) and of
JAX's uninterrupted dp 2 x pp 2 run (``test_torch_elastic.py``'s
tolerance). A restore under pp 4 changes the layer leaves' global shape
([2, 2, ...] saved, [4, 1, ...] wanted): it raises ValueError naming the
leaf on every rank, as JAX cannot resume that either. The checkpoint's
``sharding_meta.json`` is byte-equal JAX's record of the pp 2 state as
its build places it (the layer specs ``("pp",) + spec``, m and v by the
param specs).

Two spawns (``testing.dist.elastic_job``): world 2, then world 4, each
joined within ``JOIN_S`` seconds.
"""
import filecmp
import os

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.checkpoint.manager import \
    CheckpointManager as JaxManager
from paddle_tpu.models import llama as jl

from paddle_tpu_torch.testing import dist as td

KW = dict(vocab=128, hidden=32, layers=4, heads=4, kv_heads=4, inter=64,
          seq=64)
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=4, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64)
LR, STEPS, SAVE_AT, JOIN_S, M = 1e-3, 4, 2, 150, 4
LAYOUTS = {"pp2": dict(pp=2, microbatches=M),
           "dp2_pp2": dict(dp=2, pp=2, microbatches=M),
           "pp4": dict(pp=4, microbatches=M)}


def _batches():
    rng = np.random.RandomState(5)
    ids = np.stack([rng.randint(0, KW["vocab"], (8, 32)).astype(np.int32)
                    for _ in range(STEPS)])
    return ids, np.roll(ids, -1, 2).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's uninterrupted losses at dp 2 x pp 2, its elastic tail (pp 2
    saving step 2, dp 2 x pp 2 restoring), the record of the built pp 2
    state and the initial params (numpy, [L, ...] layers)."""
    config = jl.llama_tiny(**KW)
    ids, labels = _batches()
    root = tmp_path_factory.mktemp("jax_ckpt")
    init = jax.tree_util.tree_map(
        np.asarray, jl.init_llama_params(config, 0))
    built, ref = {}, {}
    for name in ("pp2", "dp2_pp2"):
        par = jl.ParallelConfig(use_flash=False, remat=False,
                                **LAYOUTS[name])
        mesh = jl.make_mesh(par, devices=jax.devices("cpu")[:par.total])
        step, p, o = jl.build_train_step(config, par, mesh=mesh, lr=LR)
        if name == "pp2":       # the state as the build places it
            JaxManager(str(root / "built")).save(
                {"params": p, "opt": o, "step": 0}, 0, block=True)
        losses = []
        for i in range(STEPS):
            p, o, loss = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
            if i + 1 == SAVE_AT and name == "pp2":
                JaxManager(str(root / name)).save(
                    {"params": p, "opt": o, "step": SAVE_AT}, SAVE_AT,
                    block=True)
        built[name], ref[name] = (step, p, o), losses
    step, p, o = built["dp2_pp2"]
    state = {"params": p, "opt": o, "step": 0}
    assert JaxManager(str(root / "pp2")).restore(state) == SAVE_AT
    p, o, tail = state["params"], state["opt"], []
    for i in range(SAVE_AT, STEPS):
        p, o, loss = step(p, o, ids[i], labels[i])
        tail.append(float(loss))
    return {"ref": ref, "tail": tail, "init": init,
            "built_dir": str(root / "built" / f"step_{0:08d}")}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Every rank's report of the two spawns, by world, and the root."""
    tmp = tmp_path_factory.mktemp("pp_elastic")
    ids, labels = _batches()
    np.savez(tmp / "batches.npz", ids=ids, labels=labels)
    np.savez(tmp / "weights.npz", **_flat(jax_side["init"]))
    root = str(tmp / "pp2")
    job = dict(config=dict(CFG, dtype="float32"), lr=LR,
               weights=str(tmp / "weights.npz"),
               batches=str(tmp / "batches.npz"))
    reports = {}
    for world, tasks in (
            (2, [dict(name="source", kind="train", parallel=LAYOUTS["pp2"],
                      root=root, save_at=SAVE_AT)]),
            (4, [dict(name="dp2_pp2", kind="restore",
                      parallel=LAYOUTS["dp2_pp2"], root=root, step=SAVE_AT,
                      check_slices=True),
                 dict(name="pp4", kind="restore", parallel=LAYOUTS["pp4"],
                      root=root, step=SAVE_AT)])):
        store = tmp / f"store{world}"
        store.mkdir()
        reports[world] = td.spawn(td.elastic_job, world,
                                  (dict(job, tasks=tasks),),
                                  timeout=JOIN_S, store_dir=str(store))
    return reports, root


def test_source_matches_jax_uninterrupted(jax_side, port_side):
    reports, _ = port_side
    for r in reports[2]:
        np.testing.assert_allclose(r["tasks"]["source"]["losses"],
                                   jax_side["ref"]["pp2"], rtol=1e-4,
                                   atol=1e-6)


def test_restore_under_dp2_pp2_reads_each_slice_bitwise(port_side):
    reports, _ = port_side
    for r in reports[4]:
        got = r["tasks"]["dp2_pp2"]
        assert got["restored"] == SAVE_AT
        # params, m and v: 12 leaves each (9 layer names, embed,
        # final_norm, lm_head), and the step count t
        assert got["compared"] == 37 and got["differing"] == []


def test_elastic_tail_matches_jax(jax_side, port_side):
    reports, _ = port_side
    tails = [r["tasks"]["dp2_pp2"]["losses"] for r in reports[4]]
    assert all(t == tails[0] for t in tails)
    np.testing.assert_allclose(tails[0], jax_side["tail"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tails[0], jax_side["ref"]["dp2_pp2"][SAVE_AT:],
                               rtol=1e-4, atol=1e-6)


def test_restore_across_pp_degrees_raises_naming_the_leaf(port_side):
    reports, _ = port_side
    for r in reports[4]:
        raised = r["tasks"]["pp4"]["raised"]
        assert raised.startswith("ValueError: checkpoint leaf ") and \
            "layers" in raised and "saved shape (2, 2," in raised, raised


def test_sharding_meta_is_jax_s(jax_side, port_side):
    _, root = port_side
    name = "sharding_meta.json"
    assert filecmp.cmp(os.path.join(root, f"step_{SAVE_AT:08d}", name),
                       os.path.join(jax_side["built_dir"], name),
                       shallow=False)


def test_spawned_ranks_import_no_jax(port_side):
    reports, _ = port_side
    for world, ranks in reports.items():
        for r in ranks:
            assert r["jax_modules"] == [], (world, r["jax_modules"])
