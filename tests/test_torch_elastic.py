"""Port parity: elastic resume. paddle_tpu_torch's ``CheckpointManager``
saves a Llama train state over ranks (one gloo process a rank on the
CPU) and restores it under another dp x sharding x mp layout and world
size, against paddle_tpu's ``build_train_step`` and ``CheckpointManager``
on its 8-device virtual CPU mesh, following the JAX package's
preemption-resume dry run (``__graft_entry__._preempt_resume_dryrun``).

The dry run's config, ``llama_tiny(vocab=128, hidden=32, layers=2,
heads=4, kv_heads=4, inter=64, seq=64)``, four ``RandomState(5)``
batches of (8, 32), labels rolled by one, lr 1e-3, ``use_flash=False``
and no remat on both sides; the port's ranks start from JAX's initial
weights (``shard_train_state``, zero moments). A run trains steps 1-2
under its source layout, checkpoints step 2, and a fresh
``restore_train_step`` under the target layout runs steps 3-4:

=====================  ===============================  ==============
save (W ranks)         restore (W')                     run in
=====================  ===============================  ==============
dp2 x mp2 (4)          dp2 x mp2 (4)                    world-4 spawn
dp2 x mp2 (4)          mp4 (4)                          world-4 spawn
dp2 x mp2 (4)          sharding 2, stage 3 (2)          second world-2
dp2 x mp2 (4)          one process (1)                  this process
sharding 2, stage 1    dp2 x mp2 (4)                    world-4 spawn
=====================  ===============================  ==============

Tolerances: the losses of steps 3-4 within ``rtol=1e-4, atol=1e-6`` of
JAX's elastic tail (JAX's manager saving at the source mesh and
restoring at the target mesh) and of JAX's uninterrupted run at the
target mesh (the dry run's own tolerance: the reduction order changes
with the layout); the same-layout row bitwise the port's own
uninterrupted run. Also: the 4-rank checkpoint's leaf files, index and
manifest checksums byte-equal a one-process ``save_state_dict`` of the
same state, and its ``sharding_meta.json`` byte-equal JAX's; a crash
matrix sample over the ranks (a write-side and a commit-side fault on
the coordinator, a write fault on rank 1) leaves ``latest()`` at 2 on
every rank; a preemption asked for on rank 1 alone stops every rank at
step 3 with a final save, from which a resume is bitwise; a mismatched
global shape raises ValueError naming the leaf on every rank; a call
over ranks without a layout raises ValueError, and a peer that never
joins a save or a restore makes the others raise after their timeout;
and a one-process engine's ``swap_weights`` from the 4-rank root serves
its params.

Three spawns (``testing.dist.elastic_job``, each with its own
``FileStore``): world 2 (the sharding-2 stage-1 source), world 4, world
2 (the stage-3 target), each joined within ``JOIN_S`` seconds.
"""
import filecmp
import os

import numpy as np
import pytest

import jax

from paddle_tpu.distributed.checkpoint.manager import \
    CheckpointManager as JaxManager
from paddle_tpu.models import llama as jl

from paddle_tpu_torch.distributed.checkpoint import save_load as sl
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.inference import InferenceEngine, Request, ServeConfig
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.testing import dist as td

KW = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=4, inter=64,
          seq=64)
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64)
LR, STEPS, SAVE_AT, JOIN_S = 1e-3, 4, 2, 150
LAYOUTS = {"dp2_mp2": dict(dp=2, mp=2), "mp4": dict(mp=4),
           "sh2_stage3": dict(sharding=2, zero_stage=3),
           "sh2_stage1": dict(sharding=2, zero_stage=1), "one": {}}
# row -> (source layout, target layout)
ROWS = {"dp2_mp2->dp2_mp2": ("dp2_mp2", "dp2_mp2"),
        "dp2_mp2->mp4": ("dp2_mp2", "mp4"),
        "dp2_mp2->sh2_stage3": ("dp2_mp2", "sh2_stage3"),
        "dp2_mp2->one": ("dp2_mp2", "one"),
        "sh2_stage1->dp2_mp2": ("sh2_stage1", "dp2_mp2")}
# (point, rank it is armed on)
CRASH = [("ckpt.write.before_publish", 0), ("ckpt.commit.before_marker", 0),
         ("ckpt.write.begin", 1)]
PREEMPT_RANK = 1
PEER_WAIT_S = 2.0


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
    """JAX's uninterrupted losses at every layout, its elastic tails (its
    manager saving step 2 at the source mesh, restoring at the target
    mesh) by row, its dp2 x mp2 step-2 checkpoint directory and the
    initial params (numpy)."""
    config = jl.llama_tiny(**KW)
    ids, labels = _batches()
    cpus = jax.devices("cpu")
    root = tmp_path_factory.mktemp("jax_ckpt")
    built, ref, init = {}, {}, None
    for name, kw in LAYOUTS.items():
        par = jl.ParallelConfig(use_flash=False, remat=False, **kw)
        mesh = jl.make_mesh(par, devices=cpus[:par.total])
        step, p, o = jl.build_train_step(config, par, mesh=mesh, lr=LR)
        if init is None:
            init = jax.tree_util.tree_map(np.asarray, p)
        if name == "dp2_mp2":       # the state as the build places it
            JaxManager(str(root / "built")).save(
                {"params": p, "opt": o, "step": 0}, 0, block=True)
        losses = []
        for i in range(STEPS):
            p, o, loss = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
            if i + 1 == SAVE_AT and name in ("dp2_mp2", "sh2_stage1"):
                JaxManager(str(root / name)).save(
                    {"params": p, "opt": o, "step": SAVE_AT}, SAVE_AT,
                    block=True)
        built[name], ref[name] = (step, p, o), losses
    tails = {}
    for row, (src, dst) in ROWS.items():
        step, p, o = built[dst]
        state = {"params": p, "opt": o, "step": 0}
        assert JaxManager(str(root / src)).restore(state) == SAVE_AT
        p, o, losses = state["params"], state["opt"], []
        for i in range(SAVE_AT, STEPS):
            p, o, loss = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
        tails[row] = losses
    return {"ref": ref, "tails": tails, "init": init,
            "dp2_mp2_dir": str(root / "dp2_mp2" / f"step_{SAVE_AT:08d}"),
            "built_dir": str(root / "built" / f"step_{0:08d}")}


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Every rank's report of the three spawns, by world (the second
    world-2 spawn under "2b"), and the two roots."""
    tmp = tmp_path_factory.mktemp("elastic")
    ids, labels = _batches()
    np.savez(tmp / "batches.npz", ids=ids, labels=labels)
    np.savez(tmp / "weights.npz", **_flat(jax_side["init"]))
    roots = {n: str(tmp / n) for n in ("dp2_mp2", "sh2_stage1")}
    job = dict(config=dict(CFG, dtype="float32"), lr=LR,
               weights=str(tmp / "weights.npz"),
               batches=str(tmp / "batches.npz"),
               env={"PADDLE_TPU_TORCH_FAULTS": "1"})

    def spawn(world, tasks):
        store = tmp / f"store{world}_{len(reports)}"
        store.mkdir()
        return td.spawn(td.elastic_job, world, (dict(job, tasks=tasks),),
                        timeout=JOIN_S, store_dir=str(store))

    def restore(row, step=SAVE_AT, **extra):
        src, dst = ROWS[row] if row in ROWS else row
        return dict(name=row, kind="restore", parallel=LAYOUTS[dst],
                    root=roots[src], step=step, **extra)
    reports = {}
    reports[2] = spawn(2, [dict(name="source", kind="train",
                                parallel=LAYOUTS["sh2_stage1"],
                                root=roots["sh2_stage1"], save_at=SAVE_AT),
                           dict(name="peers", kind="peers",
                                parallel=LAYOUTS["sh2_stage1"],
                                root=str(tmp / "peers"), wait=PEER_WAIT_S)])
    reports[4] = spawn(4, [
        dict(name="source", kind="train", parallel=LAYOUTS["dp2_mp2"],
             root=roots["dp2_mp2"], save_at=SAVE_AT, crash=CRASH,
             preempt=PREEMPT_RANK),
        restore("dp2_mp2->dp2_mp2"), restore("dp2_mp2->mp4"),
        restore("sh2_stage1->dp2_mp2"),
        dict(restore(("dp2_mp2", "dp2_mp2"), step=None), name="preempted"),
        dict(restore(("dp2_mp2", "dp2_mp2")), name="mismatch",
             config=dict(intermediate_size=128))])
    reports["2b"] = spawn(2, [restore("dp2_mp2->sh2_stage3")])
    return reports, roots


def _tail(port_side, row):
    """The restored run's losses (steps 3-4), the same on every rank."""
    reports, _ = port_side
    key = "2b" if ROWS[row][1] == "sh2_stage3" else 4
    got = [r["tasks"][row] for r in reports[key]]
    for g in got:
        assert g["restored"] == SAVE_AT and g["losses"] == got[0]["losses"]
    return got[0]["losses"]


def _one_process_restore(port_side, step=SAVE_AT):
    """A one-process state restored from the 4-rank root's step (no
    layout: whole leaves), with its train step."""
    _, roots = port_side
    cfg = tl.llama_tiny(**KW)
    step_fn, p, o = tl.build_train_step(
        cfg, tl.ParallelConfig(use_flash=False, remat=False), lr=LR,
        device="cpu")
    state = {"params": p, "opt": o, "step": 0}
    assert CheckpointManager(roots["dp2_mp2"]).restore(state, step) == step
    return step_fn, state


@pytest.mark.parametrize("row", list(ROWS))
def test_elastic_tail_matches_jax(jax_side, port_side, row):
    if ROWS[row][1] == "one":
        step_fn, state = _one_process_restore(port_side)
        ids, labels = _batches()
        tail = []
        for i in range(SAVE_AT, STEPS):
            state["params"], state["opt"], loss = step_fn(
                state["params"], state["opt"], ids[i], labels[i])
            tail.append(float(loss))
    else:
        tail = _tail(port_side, row)
    np.testing.assert_allclose(tail, jax_side["tails"][row], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tail, jax_side["ref"][ROWS[row][1]][SAVE_AT:],
                               rtol=1e-4, atol=1e-6)
    if ROWS[row][0] == ROWS[row][1]:
        # the same layout: bitwise the port's own uninterrupted run
        reports, _ = port_side
        for r in reports[4]:
            assert tail == r["tasks"]["source"]["losses"][SAVE_AT:]


def test_sources_match_jax_uninterrupted(jax_side, port_side):
    reports, _ = port_side
    for world, name in ((4, "dp2_mp2"), (2, "sh2_stage1")):
        for r in reports[world]:
            np.testing.assert_allclose(r["tasks"]["source"]["losses"],
                                       jax_side["ref"][name], rtol=1e-4,
                                       atol=1e-6)


def test_four_rank_checkpoint_is_a_one_process_save(port_side, tmp_path):
    """Leaf files, index and checksums byte-equal a one-process
    save_state_dict of the same state, restored into one process."""
    _, roots = port_side
    src = os.path.join(roots["dp2_mp2"], f"step_{SAVE_AT:08d}")
    _, state = _one_process_restore(port_side)
    one = str(tmp_path / "one")
    sl.save_state_dict(state, one, manifest={"step": SAVE_AT})
    n = len(os.listdir(os.path.join(one, sl.ARRAYS)))
    assert n == len(os.listdir(os.path.join(src, sl.ARRAYS))) == 38
    files = [sl.INDEX] + [f"{sl.ARRAYS}/{i}.bin" for i in range(n)]
    match, mismatch, errors = filecmp.cmpfiles(one, src, files,
                                               shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == n + 1
    assert sl.load_manifest(one) == sl.load_manifest(src)
    assert sl.load_sharding_meta(one) == {"leaf_shardings": [None] * n}


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def test_sharding_meta_is_jax_s(jax_side, port_side):
    """Byte-equal JAX's record of the dp2 x mp2 state as its build places
    it (the specs of ``param_pspecs`` and ``opt_state_pspecs``, ``t``
    uncommitted). After JAX's jitted steps XLA hands the leaves back
    with equivalent specs: most without their trailing Nones, ``t``
    committed replicated (``[]``); the step-2 record agrees up to
    that."""
    _, roots = port_side
    ours = os.path.join(roots["dp2_mp2"], f"step_{SAVE_AT:08d}")
    name = "sharding_meta.json"
    assert filecmp.cmp(os.path.join(ours, name),
                       os.path.join(jax_side["built_dir"], name),
                       shallow=False)
    mine = sl.load_sharding_meta(ours)["leaf_shardings"]
    theirs = sl.load_sharding_meta(jax_side["dp2_mp2_dir"])[
        "leaf_shardings"]
    assert len(mine) == len(theirs) == 38
    assert mine[12] is None and mine[-1] is None         # opt.t, step
    assert theirs[12]["spec"] == [] and theirs[-1] is None
    for a, b in zip(mine[:12] + mine[13:-1], theirs[:12] + theirs[13:-1]):
        assert a["mesh_shape"] == b["mesh_shape"] == [2, 1, 1, 1, 2]
        assert a["mesh_axes"] == b["mesh_axes"]
        assert _strip(a["spec"]) == _strip(b["spec"]), (a, b)


@pytest.mark.parametrize("i", range(len(CRASH)), ids=[
    f"{p}@rank{r}" for p, r in CRASH])
def test_a_fault_on_any_rank_keeps_latest_on_every_rank(port_side, i):
    reports, _ = port_side
    for r in reports[4]:
        raised, latest = r["tasks"]["source"]["crash"][i]
        assert raised is not None and latest == SAVE_AT, (i, raised, latest)


def test_preemption_on_one_rank_stops_every_rank(port_side):
    """Rank 1 alone asks; every rank raises Preempted at step 3 with its
    final save made, and a resume from it runs step 4 bitwise."""
    reports, roots = port_side
    for r in reports[4]:
        assert r["tasks"]["source"]["preempted"] == (SAVE_AT + 1, True)
        got = r["tasks"]["preempted"]
        assert got["restored"] == SAVE_AT + 1
        assert got["losses"] == r["tasks"]["source"]["losses"][SAVE_AT + 1:]
    assert CheckpointManager(roots["dp2_mp2"]).steps() == [2, 3]


def test_mismatched_global_shape_raises_naming_the_leaf(port_side):
    reports, _ = port_side
    for r in reports[4]:
        msg = r["tasks"]["mismatch"]["raised"]
        assert msg.startswith("ValueError") and "gate_proj" in msg, msg


def test_one_process_engine_swaps_from_the_four_rank_root(port_side):
    """The newest step (the preemption's final save) is served."""
    _, roots = port_side
    cfg = tl.llama_tiny(**KW)
    saved = sl.read_tree(CheckpointManager(roots["dp2_mp2"]).latest_path())
    want = tl._tree_map(lambda leaf: leaf.read(), saved["params"])
    serve = ServeConfig(block_size=128, num_blocks=4, max_batch=1,
                        prefill_chunk=32, max_seq_len=64)
    eng = InferenceEngine(tl.init_llama_params(cfg, seed=1, device="cpu"),
                          cfg, serve, device="cpu")
    eng.swap_weights(roots["dp2_mp2"])
    for k, v in td.flat_tree(want).items():
        np.testing.assert_array_equal(td.flat_tree(eng.params)[k], v)
    ref = InferenceEngine(want, cfg, serve, device="cpu")
    reqs = [Request([3, 7, 11, 5], max_new_tokens=6, request_id=0)]
    eng.run(reqs, deterministic=True)
    ref.run([Request([3, 7, 11, 5], max_new_tokens=6, request_id=0)],
            deterministic=True)
    assert [s.tokens for s in eng.finished] == [s.tokens
                                                 for s in ref.finished]


def test_multi_rank_calls_without_a_layout_raise(port_side):
    reports, _ = port_side
    for r in reports[2]:
        for what in ("save_without_layout", "load_without_layout"):
            msg = r["tasks"]["peers"][what]
            assert msg.startswith("ValueError") and "layout" in msg, msg


def test_a_peer_that_never_joins_is_an_error_not_a_hang(port_side):
    """Rank 1 never joins a save and rank 0 never joins a restore: the
    rank that did raises once its wait of PEER_WAIT_S runs out."""
    reports, _ = port_side
    saved, restored = (r["tasks"]["peers"] for r in reports[2])
    assert "waited 2.0 s" in saved["save"], saved
    assert restored["restore"].startswith("TimeoutError"), restored
    assert "waited 2.0 s" in restored["restore"], restored
    for r in (saved, restored):
        assert PEER_WAIT_S <= r["seconds"] < 10 * PEER_WAIT_S, r


def test_spawned_ranks_import_no_jax(port_side):
    reports, _ = port_side
    for key, rs in reports.items():
        for r in rs:
            assert r["jax_modules"] == [], (key, r["jax_modules"])
