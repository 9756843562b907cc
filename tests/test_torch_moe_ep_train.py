"""Port parity: paddle_tpu_torch's ERNIE-MoE ``build_train_step`` over ranks
(``ep_degree`` x ``dp_degree`` gloo processes on the CPU) against
paddle_tpu's ``build_train_step(cfg, ep_degree=, dp_degree=)`` on its
("dp", "ep") mesh of the conftest's devices.

The same numpy weights (JAX's ``init_params``) and batches (B 4, S 16;
row 0 keeps 6 of its labels) go through three AdamW steps at lr 1e-3 on
both sides: ``ernie_moe_tiny`` (E 4, top-2) at dp 2 (capacity, ragged),
ep 2 (capacity, ragged, ragged_a2a) and dp 2 x ep 2 (capacity,
ragged_a2a); ``ernie_moe_fine_tiny`` (E 8, a shared expert, ragged_a2a,
``with_stats``, ``active_only_moments``, ``multi_precision=False``) at
ep 4 and dp 2 x ep 2; the non-split layer stack (``moe_every`` 3, each
layer recomputed) at ep 2 and dp 2 x ep 2. Losses within 1e-5
relative, stats counts exact and ratios within 1e-6. Params within
``PARAM_ATOL`` of JAX's: Adam moves an element whose gradient lies near
its eps by lr x g / eps, so the last-ulp differences of any two
implementations show there (the port's single-process step is 2.2e-5 off
JAX's on ``ernie_moe_tiny`` after the same three steps), and the bound is
``tests/test_torch_moe_capacity.py``'s 0.1 x lr; the gradients, which
Adam's step would hide, are held to ``jax.value_and_grad`` of JAX's
``moe_loss`` on the mesh at 1e-5 of each leaf's largest, for dp 2, ep 2
and dp 2 x ep 2 in each dispatch mode. What ep and dp add is held apart
from that gap at ``SINGLE_ATOL`` (5e-6): each run whose function is the
port's single-process step runs again in f64 against that step, and
ragged_a2a over dp 2 x ep 2 against the same function over ep 4.

Capacity overflow at dp 2: a router skewed onto expert 0 drops about
40% of the pairs; the port's drop counts and losses are JAX's global
ones, and a control whose ranks route with their own rows' capacity
(``testing.dist.moe_job``'s ``local_capacity``) fails that check. With
every rank's gradients scaled apart (``ep_noise``), the leaves ep does
not split still hold one value on every rank.

The ranks run ``paddle_tpu_torch.testing.dist.moe_job`` (torch and the
port only): one spawn of 2 ranks and one of 4 carry every run, each with
a ``FileStore`` in its own temp directory and a join limit of ``JOIN_S``
seconds, started in a thread before this process computes JAX's side;
the JAX mesh steps are jitted once per run.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.models import ernie_moe as jm
from paddle_tpu.parallel.moe import RATIO_STAT_KEYS

from paddle_tpu_torch.testing import dist as td

B, S, STEPS, LR, JOIN_S = 4, 16, 3, 1e-3, 300
PARAM_ATOL = 0.1 * LR
FINE_FLAGS = dict(with_stats=True, active_only_moments=True,
                  multi_precision=False)
# name -> (config, ep, dp, dispatch mode, extra flags, steps, gradients)
RUNS = {
    "tiny_dp2_capacity": ("tiny", 1, 2, "capacity", {}, True, True),
    "tiny_dp2_ragged": ("tiny", 1, 2, "ragged", {}, True, True),
    "tiny_dp2_ragged_a2a": ("tiny", 1, 2, "ragged_a2a", {}, False, True),
    "tiny_ep2_capacity": ("tiny", 2, 1, "capacity", {}, True, True),
    "tiny_ep2_ragged": ("tiny", 2, 1, "ragged", {}, True, True),
    "tiny_ep2_ragged_a2a": ("tiny", 2, 1, "ragged_a2a", {}, True, True),
    "tiny_dp2_ep2_capacity": ("tiny", 2, 2, "capacity", {}, True, True),
    "tiny_dp2_ep2_ragged": ("tiny", 2, 2, "ragged", {}, False, True),
    "tiny_dp2_ep2_ragged_a2a": ("tiny", 2, 2, "ragged_a2a", {}, True,
                                True),
    "fine_ep4_ragged_a2a": ("fine", 4, 1, "ragged_a2a", FINE_FLAGS, True,
                            False),
    "fine_dp2_ep2_ragged_a2a": ("fine", 2, 2, "ragged_a2a", FINE_FLAGS,
                                True, False),
    "nonsplit_ep2_ragged": ("nonsplit", 2, 1, "ragged", {}, True, False),
    "nonsplit_dp2_ep2_capacity": ("nonsplit", 2, 2, "capacity", {}, True,
                                  False),
    "overflow_dp2_capacity": ("overflow", 1, 2, "capacity", {}, True,
                              False),
}
STEP_RUNS = [n for n, r in RUNS.items() if r[5]]
GRAD_RUNS = [n for n, r in RUNS.items() if r[6]]
# the runs whose function is the port's single-process step: dp alone
# routes the global token set; ep at dp 1 outside ragged_a2a routes every
# token on every ep rank, with the aux of all of them. Each runs again in
# f64 (the router stays f32), held to the port's single-process step at
# SINGLE_ATOL: in f32, Adam's m / (sqrt(v) + eps) turns the last-ulp
# differences of a gradient element that cancels into 8e-6 to 1.1e-5 of
# one param element at dp 2
SINGLE_RUNS = [n for n in STEP_RUNS if RUNS[n][1] == 1
               or (RUNS[n][2] == 1 and RUNS[n][3] != "ragged_a2a")]
SINGLE_ATOL = 5e-6
# ragged_a2a over dp 2 x ep 2 and over ep 4 split the tokens into the same
# four blocks (rank d * ep + e takes block d * ep + e), each with its own
# aux: one function, two layouts
SAME_FUNCTION = ("fine_dp2_ep2_ragged_a2a", "fine_ep4_ragged_a2a")
CONTROL = "overflow_dp2_local_capacity"
NOISE = "tiny_dp2_ep2_ep_noise"
CONTROL_WORLDS = {CONTROL: 2, NOISE: 4}


def _jax_config(name):
    if name == "tiny":
        return jm.ernie_moe_tiny()
    if name == "nonsplit":
        return dataclasses.replace(jm.ernie_moe_tiny(), moe_every=3)
    if name == "fine":
        return jm.ernie_moe_fine_tiny()
    return dataclasses.replace(jm.ernie_moe_fine_tiny(),
                               dispatch_mode="capacity",
                               num_shared_experts=0)


def _port_config(cfg):
    return dict({f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}, dtype="float32")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.array(v)
    return out


def _unflat(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _weights(name, dtype=np.float32):
    """JAX's init_params as numpy; the overflow model's router skewed onto
    expert 0 (embedding column 0 lifted, every MoE gate reading it).
    Every leaf but the router gate (f32) in ``dtype``."""
    w = _flat(jax.tree_util.tree_map(np.asarray,
                                     jm.init_params(_jax_config(name), 0)))
    if name == "overflow":
        w["embed"][:, 0] += 1.0
        w["layers/moe/gate"][:, 0, 0] = 1.0
    return {k: a if k.endswith("/gate") else a.astype(dtype)
            for k, a in w.items()}


def _batches(name):
    rng = np.random.RandomState(7)
    s = 64 if name == "overflow" else S     # 256 tokens: pairs drop
    ids = rng.randint(0, 256, size=(STEPS, B, s)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2)
    labels[:, :, -1] = -100
    labels[:, 0, :s - 6] = -100     # rank 0's first row keeps 6 labels
    return ids, labels


def _flags(run):
    _, _, _, mode, extra, _, _ = RUNS[run]
    return dict({"with_stats": True}, dispatch_mode=mode, **extra)


def _mesh(ep, dp):
    return Mesh(np.array(jax.devices("cpu")[:ep * dp]).reshape(dp, ep),
                ("dp", "ep"))


def _spawn_port(tmp_path_factory):
    """{world: (every rank's report, rank 0's directory)}."""
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"moe{world}")
        runs = []
        for run, (cname, ep, dp, _, _, steps, grads) in RUNS.items():
            if ep * dp != world:
                continue
            np.savez(tmp / f"w_{cname}.npz", **_weights(cname))
            ids, labels = _batches(cname)
            np.savez(tmp / f"b_{run}.npz", ids=ids if steps else ids[:1],
                     labels=labels if steps else labels[:1])
            base = dict(name=run, ep=ep, dp=dp, flags=_flags(run),
                        grads=grads, weights=str(tmp / f"w_{cname}.npz"),
                        batches=str(tmp / f"b_{run}.npz"),
                        config=_port_config(_jax_config(cname)))
            runs.append(base)
            if run == "overflow_dp2_capacity":
                runs.append(dict(base, name=CONTROL, grads=False,
                                 control="local_capacity"))
            if run == "tiny_dp2_ep2_ragged_a2a":
                runs.append(dict(base, name=NOISE, grads=False,
                                 control="ep_noise"))
            if run in SINGLE_RUNS:
                np.savez(tmp / f"w_{cname}_f64.npz",
                         **_weights(cname, np.float64))
                runs.append(dict(base, name=f"{run}_f64", grads=False,
                                 weights=str(tmp / f"w_{cname}_f64.npz"),
                                 config=dict(base["config"],
                                             dtype="float64")))
        job = dict(config=_port_config(jm.ernie_moe_tiny()), lr=LR,
                   out=str(tmp), runs=runs)
        out[world] = (td.spawn(td.moe_job, world, (job,), timeout=JOIN_S,
                               store_dir=str(tmp)), tmp)
    return out


@pytest.fixture(scope="module")
def port_future(tmp_path_factory):
    """The port's spawns, started first and run in a thread while this
    process computes JAX's side."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_spawn_port, tmp_path_factory)


@pytest.fixture(scope="module")
def port_runs(port_future, jax_runs, jax_grads):
    return port_future.result()


@pytest.fixture(scope="module")
def jax_runs(port_future):
    """{run: (losses, stats a step, params)} of JAX's mesh step."""
    out = {}
    for run in STEP_RUNS:
        cname, ep, dp = RUNS[run][:3]
        cfg = _jax_config(cname)
        ids, labels = _batches(cname)
        step, p, o = jm.build_train_step(cfg, ep_degree=ep, dp_degree=dp,
                                         lr=LR, **_flags(run))
        p = jax.tree_util.tree_map(lambda a, ref: jax.device_put(
            a, ref.sharding), _unflat(_weights(cname)), p)
        losses, stats = [], []
        for i in range(STEPS):
            p, o, loss, st = step(p, o, ids[i], labels[i])
            losses.append(float(loss))
            stats.append({k: np.asarray(v) for k, v in st.items()})
        out[run] = (losses, stats, _flat(jax.tree_util.tree_map(np.asarray,
                                                                p)))
    return out


@pytest.fixture(scope="module")
def jax_grads(port_future):
    """{run: gradients} of jax.value_and_grad(moe_loss) on JAX's mesh at
    the first batch."""
    out = {}
    for run in GRAD_RUNS:
        cname, ep, dp, mode = RUNS[run][:4]
        cfg = _jax_config(cname)
        mesh = _mesh(ep, dp)
        p = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            _unflat(_weights(cname)), jm.param_pspecs(cfg, ep, dp),
            is_leaf=lambda x: not isinstance(x, dict))
        rows = NamedSharding(mesh, P("dp", None))
        ids, labels = _batches(cname)
        grad = jax.jit(jax.grad(lambda p, i, l: jm.moe_loss(
            p, i, l, cfg, ep > 1, mesh if ep > 1 else None, False,
            mode)[0]))
        g = grad(p, jax.device_put(ids[0], rows),
                 jax.device_put(labels[0], rows))
        out[run] = _flat(jax.tree_util.tree_map(np.asarray, g))
    return out


def _port(port_runs, run):
    base = run[:-len("_f64")] if run.endswith("_f64") else run
    world = RUNS[base][1] * RUNS[base][2] if base in RUNS \
        else CONTROL_WORLDS[run]
    reports, tmp = port_runs[world]
    res = np.load(tmp / f"{run}.npz")
    return ([r["runs"][run] for r in reports], list(res["losses"]),
            {k[2:]: res[k] for k in res.files if k.startswith("p:")},
            {k[2:]: res[k] for k in res.files if k.startswith("g:")})


@pytest.mark.parametrize("run", STEP_RUNS)
def test_losses_and_stats_match_jax(jax_runs, port_runs, run):
    ranks, losses, _, _ = _port(port_runs, run)
    want_losses, want_stats, _ = jax_runs[run]
    for r in ranks:             # the same float on every rank
        assert r["losses"] == losses
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for got, want in zip(ranks[0]["stats"], want_stats):
        assert got.keys() == want.keys()
        for key, w in want.items():
            if key == "lm_loss":
                np.testing.assert_allclose(got[key], w, rtol=1e-5)
            elif key in RATIO_STAT_KEYS:
                np.testing.assert_allclose(got[key], w, rtol=1e-6,
                                           err_msg=key)
            else:           # counts: exact
                np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert not any(r["jax_modules"] for r in
                   port_runs[RUNS[run][1] * RUNS[run][2]][0])


@pytest.mark.parametrize("run", STEP_RUNS)
def test_params_match_jax(jax_runs, port_runs, run):
    _, _, params, _ = _port(port_runs, run)
    want = jax_runs[run][2]
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def port_single(port_future):
    """{run: params} of the port's single-process step (ep 1, dp 1) in f64
    on the same weights, batches and flags, for SINGLE_RUNS."""
    import torch
    from paddle_tpu_torch.models import ernie_moe as tm
    out = {}
    for run in SINGLE_RUNS:
        cname, flags = RUNS[run][0], _flags(run)
        cfg = tm.ErnieMoEConfig(**dict(_port_config(_jax_config(cname)),
                                       dtype=torch.float64))
        step, _, _ = tm.build_train_step(cfg, lr=LR, device="cpu", **flags)
        p = td._numpy_tree(_weights(cname, np.float64))
        o = tm._adamw_init(p, flags.get("multi_precision", True))
        ids, labels = _batches(cname)
        for i in range(STEPS):
            p, o, _, _ = step(p, o, ids[i], labels[i])
        out[run] = td.flat_tree(p)
    return out


@pytest.mark.parametrize("run", SINGLE_RUNS)
def test_params_match_port_single_process(port_single, port_runs, run):
    """What ep and dp add alone: the f64 twin's params after the steps
    within SINGLE_ATOL of the port's own single-process step."""
    _, _, params, _ = _port(port_runs, f"{run}_f64")
    want = port_single[run]
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=SINGLE_ATOL,
                                   rtol=0, err_msg=k)


def test_one_function_over_two_layouts(port_runs):
    """SAME_FUNCTION's two runs (dp 2 x ep 2 and ep 4): the same losses,
    the same routed and dropped pairs and rows an expert, and params
    within SINGLE_ATOL of each other."""
    (a, la, pa, _), (b, lb, pb, _) = (_port(port_runs, r)
                                      for r in SAME_FUNCTION)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for sa, sb in zip(a[0]["stats"], b[0]["stats"]):
        for key in ("moe_routed_tokens", "moe_dropped_tokens",
                    "moe_expert_rows"):
            assert sa[key] == sb[key], key
    for k in pb:
        np.testing.assert_allclose(pa[k], pb[k], atol=SINGLE_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("run", GRAD_RUNS)
def test_gradients_match_jax(jax_grads, port_runs, run):
    """Every leaf's gradient (gathered over ep, summed over dp), the gate,
    the experts and the attention included, within 1e-5 of the leaf's
    largest: a gradient summed ep times over would be far off."""
    _, _, _, grads = _port(port_runs, run)
    want = jax_grads[run]
    assert grads.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("run", STEP_RUNS)
def test_replicas_hold_the_same_bits(port_runs, run):
    """Ranks at one ep coordinate (dp replicas) hold the same bits of every
    leaf; every rank the same bits of the leaves ep does not split."""
    ranks, _, _, _ = _port(port_runs, run)
    for a in ranks:
        for b in ranks:
            for leaf in a["crc"]:
                if a["coord"][1] == b["coord"][1] or "e_w" not in leaf:
                    assert a["crc"][leaf] == b["crc"][leaf], (leaf, a["coord"],
                                                              b["coord"])


def test_ep_copies_stay_one_array(port_runs):
    """Each rank's gradients moved apart (``moe_job``'s ``ep_noise``: the
    losses differ by rank): the leaves ep does not split still hold the
    same bits on every rank, taken from ep rank 0, and dp replicas hold
    the same experts."""
    ranks, _, _, _ = _port(port_runs, NOISE)
    assert len({r["losses"][0] for r in ranks}) == len(ranks)
    for a in ranks:
        for b in ranks:
            for leaf in a["crc"]:
                if a["coord"][1] == b["coord"][1] or "e_w" not in leaf:
                    assert a["crc"][leaf] == b["crc"][leaf], (leaf, a["coord"],
                                                              b["coord"])


def test_mesh_groups_are_jax_layout(port_runs):
    """Rank d * ep + e sits at (d, e): its dp group the line over dp at e,
    its ep group the line over ep at d."""
    reports, _ = port_runs[4]
    for rank, r in enumerate(reports):
        got = r["runs"]["tiny_dp2_ep2_capacity"]
        d, e = divmod(rank, 2)
        assert tuple(got["coord"]) == (d, e)
        assert got["groups"] == {"dp": [e, 2 + e], "ep": [2 * d, 2 * d + 1]}


def test_a2a_counters_and_spans(port_runs):
    """The a2a's counters and JAX-named spans a step at dp 2 x ep 2 (two
    MoE layers): one hop out and back each forward and backward, one
    count exchange a layer."""
    ranks, _, _, _ = _port(port_runs, "tiny_dp2_ep2_ragged_a2a")
    for r in ranks:
        c = r["counters"]
        n_moe = 2 * STEPS
        assert c["moe.a2a.hops_total"] == n_moe
        assert "moe.a2a.hops_overlapped" not in c
        for name in ("hop", "ret_hop", "hop.grad", "ret_hop.grad",
                     "counts"):
            assert c[f"moe.ragged_a2a.{name}.calls"] == n_moe, name


def test_capacity_overflow_takes_jax_global_drop_set(jax_runs, port_runs):
    """dp 2 under capacity with pairs dropping: the port's drops, stats and
    losses are JAX's global ones (the loss test holds them to 1e-5, the
    counts exactly); the control that routes each rank with its own rows'
    capacity drops none and misses the losses."""
    ranks, losses, _, _ = _port(port_runs, "overflow_dp2_capacity")
    _, want_stats, _ = jax_runs["overflow_dp2_capacity"]
    drops = [s["moe_dropped_tokens"] for s in ranks[0]["stats"]]
    assert drops == [float(s["moe_dropped_tokens"]) for s in want_stats]
    assert min(drops) > 0.3 * B * 64 * 2 * 2       # over 30% of the pairs
    ctrl, c_losses, _, _ = _port(port_runs, CONTROL)
    c_drops = [s["moe_dropped_tokens"] for s in ctrl[0]["stats"]]
    assert c_drops != drops
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(c_losses, jax_runs[
            "overflow_dp2_capacity"][0], rtol=1e-5)
