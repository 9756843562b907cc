"""Port parity: dropless MoE routing, the MoE layer and the ERNIE-MoE train
step of paddle_tpu_torch against paddle_tpu's, on the CPU.

Inputs are made with numpy and go through both packages; the JAX side
runs Pallas in interpret mode, the port its plain PyTorch versions (CPU
tensors). Tolerances:
- routing (slots, counts, offsets, schedule, stats): bitwise on the same
  logits; the gate weights and the aux loss agree to 1e-6 relative
  (softmax's exp and the sums are the two libraries' own);
- the MoE layer in f32: 1e-5 (sums in another order); in bf16: four bf16
  steps (2^-6) of the tensor's largest value, since each side rounds
  its matmul outputs to bf16 at the same points but sums in another
  order;
- three ``build_train_step`` steps of ``ernie_moe_fine_tiny`` in f32:
  losses and lm_loss 1e-5 relative, stats bitwise (they are counts),
  params 1e-5 absolute (a param with a near-zero gradient moves by m /
  sqrt(v) x lr, where f32 noise in the gradient shows most).
Every router decision is checked to have a gap above 1e-5 (relative)
between the k-th and (k+1)-th probability, so a routing flip cannot pass
as a tolerance failure.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
import jax.numpy as jnp

from paddle_tpu.models import ernie_moe as jm
from paddle_tpu.ops import _common
from paddle_tpu.ops import grouped_matmul as jg
from paddle_tpu.parallel import moe as jmoe

from paddle_tpu_torch.models import ernie_moe as tm
from paddle_tpu_torch.models.llama import params_from_numpy
from paddle_tpu_torch.ops import grouped_matmul as tg
from paddle_tpu_torch.parallel import moe as tmoe

E, K, D, I, TILE = 8, 2, 16, 32, 8
GAP = 1e-5
# the JAX references jitted, as the train step runs them: one compile per
# shape instead of one per primitive
_j_route = jax.jit(jmoe.ragged_route, static_argnums=(1, 2))
_j_schedule = jax.jit(jg.tile_schedule, static_argnums=(1, 2))
_j_stats = jax.jit(jmoe.routing_stats_ragged, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().float().numpy()
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_gap(logits, k):
    """The k-th and (k+1)-th router probabilities of every token differ by
    more than GAP of the k-th (relative, so that a skewed router whose
    losing probabilities are all tiny is held to the same margin)."""
    p = np.sort(np.asarray(torch.softmax(torch.as_tensor(
        np.array(logits, np.float32)), -1)), -1)[:, ::-1]
    gap = (p[:, k - 1] - p[:, k]) / p[:, k - 1]
    assert gap.min() > GAP, f"router gap {gap.min():.2e} at or below {GAP}"


def _logits(seed, T=64, skew=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, E).astype(np.float32)
    if skew == "empty_experts":
        logits[:, E // 2:] -= 30.0
    elif skew == "all_to_one":
        logits[:, 0] += 20.0
    return logits


@pytest.mark.parametrize("skew", [None, "empty_experts", "all_to_one"])
def test_routing_matches_jax(skew):
    logits = _logits(5, skew=skew)
    _assert_gap(logits, K)
    slot_j, w_j, aux_j, counts_j, n_j = _j_route(jnp.asarray(logits), K,
                                                 TILE)
    n_j = int(n_j)
    slot_t, w_t, aux_t, counts_t, n_t = tmoe.ragged_route(
        torch.from_numpy(logits), K, TILE)
    assert n_t == n_j == jmoe.ragged_buffer_rows(64, K, E, TILE)
    assert slot_t.dtype == counts_t.dtype == torch.int32
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    sched_j = _j_schedule(counts_j, n_j // TILE, TILE)
    sched_t = tg.tile_schedule(counts_t, n_t // TILE, TILE)
    for a, b in zip(sched_j, sched_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    st_j = _j_stats(counts_j, K, TILE)
    st_t = tmoe.routing_stats_ragged(counts_t, K, TILE)
    assert st_j.keys() == st_t.keys()
    for key in st_j:
        np.testing.assert_array_equal(st_t[key].numpy(), np.asarray(st_j[key]),
                                      err_msg=key)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe._top_k(probs, 2)
    vj, ij = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ij).tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.from_numpy(np.array(vj)))


def _layer_inputs(dtype, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(64, D).astype(np.float32)
    logits = _logits(seed)
    w1 = (rng.randn(E, D, I) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.randn(E, I, D) / np.sqrt(I)).astype(np.float32)
    cot = rng.randn(64, D).astype(np.float32)
    return x, logits, w1, w2, cot


def _jax_layer(x, logits, w1, w2, cot, jdt):
    def f(x, logits, w1, w2):
        out, aux = jmoe.moe_ragged_dispatch_combine(
            x, logits, w1, w2, E, k=K, tile_rows=TILE)
        return out, aux

    @jax.jit
    def value_and_pull(args, cot):
        (out, aux), pull = jax.vjp(f, *args)
        return (out, aux) + tuple(pull((cot, jnp.float32(0.37))))

    args = (jnp.asarray(x, jdt), jnp.asarray(logits), jnp.asarray(w1, jdt),
            jnp.asarray(w2, jdt))
    res = value_and_pull(args, jnp.asarray(cot, jdt))
    return [np.asarray(t, np.float32) for t in res]


def _port_layer(x, logits, w1, w2, cot, tdt):
    def leaf(a, dt):
        return torch.from_numpy(a).to(dt).requires_grad_()

    xs, ls, w1s, w2s = (leaf(x, tdt), leaf(logits, torch.float32),
                        leaf(w1, tdt), leaf(w2, tdt))
    out, aux, stats = tmoe.moe_ragged_dispatch_combine(
        xs, ls, w1s, w2s, E, k=K, tile_rows=TILE, return_stats=True)
    assert out.dtype == tdt and aux.dtype == torch.float32
    torch.autograd.backward((out, aux), (torch.from_numpy(cot).to(tdt),
                                         torch.tensor(0.37)))
    return [t.detach().float().numpy()
            for t in (out, aux, xs.grad, ls.grad, w1s.grad, w2s.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(dtype):
    x, logits, w1, w2, cot = _layer_inputs(dtype)
    _assert_gap(logits, K)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = _jax_layer(x, logits, w1, w2, cot, jdt)
    got = _port_layer(x, logits, w1, w2, cot, tdt)
    names = ("out", "aux", "dx", "dlogits", "dw1", "dw2")
    for name, g, w in zip(names, got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2 ** -6,
                                       atol=2 ** -6 * np.abs(w).max(),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

FLAGS = dict(dispatch_mode="ragged_a2a", multi_precision=False,
             with_stats=True, active_only_moments=True)
EMPTY = 3       # the expert the router is skewed away from
SKEW_DIM = 5    # a hidden channel every token carries at a large value


def _skewed_params(cfg):
    """JAX init params with expert EMPTY made unreachable: embedding
    channel SKEW_DIM is raised by 0.1 for every token (five times its
    spread), so after RMSNorm it is about 3 in every token, and the
    routers read it with weight -1 for expert EMPTY (about 0.02 for the
    rest). The channel keeps its spread over the vocabulary: a channel
    equal for every vocabulary row would shift all logits of the tied
    head alike, and the gradient of its final-norm weight would be pure
    rounding noise, which AdamW amplifies to +-lr."""
    p = _np_tree(jm.init_params(cfg, seed=0))
    p["embed"] = p["embed"].copy()
    p["embed"][:, SKEW_DIM] += 0.1
    gate = p["layers"]["moe"]["gate"].copy()
    gate[:, SKEW_DIM, EMPTY] = -1.0
    p["layers"]["moe"]["gate"] = gate
    return p


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of each framework's build_train_step on the same
    weights and ids, with the router logits the port saw."""
    with _common.interpret_mode(True):
        jcfg, tcfg = jm.ernie_moe_fine_tiny(), tm.ernie_moe_fine_tiny()
        params = _skewed_params(jcfg)
        rng = np.random.RandomState(7)
        ids = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        labels = np.roll(ids, -1, 1)
        labels[:, -1] = -100
        step_j, _, _ = jm.build_train_step(jcfg, **FLAGS)
        step_t, _, _ = tm.build_train_step(tcfg, device="cpu", **FLAGS)
        p_j = jax.tree_util.tree_map(jnp.asarray, params)
        o_j = jm._adamw_init(p_j, multi_precision=False)
        p_t = params_from_numpy(params, "cpu")
        o_t = params_from_numpy(_np_tree(o_j), "cpu")
        seen = []
        route = tmoe.ragged_route

        def recording_route(logits, k, tile_rows):
            seen.append(logits.detach().numpy().copy())
            return route(logits, k, tile_rows)

        out = {"j": [], "t": []}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "ragged_route", recording_route)
            for _ in range(3):
                p_j, o_j, loss_j, st_j = step_j(p_j, o_j, ids, labels)
                p_t, o_t, loss_t, st_t = step_t(p_t, o_t, ids, labels)
                out["j"].append((float(loss_j), _np_tree(st_j)))
                out["t"].append((loss_t, {k: v.numpy()
                                          for k, v in st_t.items()}))
        return dict(init=params, out=out, seen=seen, cfg=tcfg,
                    p_j=_np_tree(p_j), o_j=_np_tree(o_j), p_t=p_t, o_t=o_t)


def test_train_step_three_steps_match_jax(three_steps):
    r = three_steps
    for logits in r["seen"]:
        _assert_gap(logits, r["cfg"].moe_topk)
    assert len(r["seen"]) == 3 * r["cfg"].num_hidden_layers // 2
    for (loss_j, st_j), (loss_t, st_t) in zip(r["out"]["j"], r["out"]["t"]):
        assert loss_t.dtype == torch.float32 and loss_t.ndim == 0
        np.testing.assert_allclose(float(loss_t), loss_j, rtol=1e-5)
        assert st_j.keys() == st_t.keys()
        np.testing.assert_allclose(st_t["lm_loss"], st_j["lm_loss"],
                                   rtol=1e-5)
        for key in st_j:
            if key != "lm_loss":
                np.testing.assert_array_equal(st_t[key], st_j[key],
                                              err_msg=key)
        assert float(st_t["moe_dropped_tokens"]) == 0.0
    losses = [float(t[0]) for t in r["out"]["t"]]
    assert losses[2] < losses[0]
    want, got = _flat(r["p_j"]), _flat(r["p_t"])
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    assert float(r["o_t"]["t"]) == 3.0
    # moments in each param's dtype (multi_precision=False); the f32 gate
    # keeps f32 moments
    assert r["o_t"]["m"]["layers"]["moe"]["gate"].dtype == torch.float32


def test_empty_expert_is_frozen_on_both_sides(three_steps):
    """Expert EMPTY routed no row in any step: its weights and moments are
    bitwise what they were before the steps, in JAX and in the port,
    while every other expert moved."""
    r = three_steps
    for _, st in r["out"]["t"]:
        assert st["moe_expert_rows"][EMPTY] == 0
        assert (np.delete(st["moe_expert_rows"], EMPTY) > 0).all()
    init = r["init"]["layers"]["moe"]
    for name in ("e_w1", "e_w2"):
        for p, o in ((r["p_j"], r["o_j"]), (r["p_t"], r["o_t"])):
            p_now = _flat(p)[f"layers/moe/{name}"]
            assert np.array_equal(p_now[:, EMPTY], init[name][:, EMPTY])
            assert not np.array_equal(p_now[:, EMPTY - 1],
                                      init[name][:, EMPTY - 1])
            for mom in ("m", "v"):
                got = _flat(o[mom])[f"layers/moe/{name}"]
                assert (got[:, EMPTY] == 0).all(), (name, mom)


def test_moe_loss_active_rows_without_stats():
    cfg = tm.ernie_moe_fine_tiny()
    params = tm.init_params(cfg, seed=2, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        total, (lm, rows) = tm.moe_loss(params, ids, ids, cfg,
                                        dispatch_mode="ragged",
                                        active_rows=True)
    assert rows.shape == (cfg.num_hidden_layers // 2, cfg.num_experts)
    assert float(rows.sum()) == 2 * 8 * cfg.moe_topk * rows.shape[0]
    assert lm.ndim == 0 and float(total) > float(lm) > 0


@pytest.mark.parametrize("kwargs,batch,what", [
    (dict(ep_degree=3), None, "ep_degree=3 does not divide num_experts=8"),
    (dict(ep_degree=2), (1, 3), "dp_degree x ep_degree = 2"),
    (dict(mesh="a mesh"), None, "mesh"),
])
def test_unported_train_configs_raise(kwargs, batch, what):
    """What the step over ranks refuses: an ep that does not divide E, a
    ragged_a2a token count that dp x ep does not divide (the step built
    under torch's in-process ``fake`` backend, two ranks, raising before
    any collective), and a mesh."""
    if batch is None:
        with pytest.raises(ValueError, match=what):
            tm.build_train_step(tm.ernie_moe_fine_tiny(), device="cpu",
                                **kwargs)
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        step, p, o = tm.build_train_step(tm.ernie_moe_fine_tiny(),
                                         device="cpu", **kwargs)
        ids = np.zeros(batch, np.int32)
        with pytest.raises(ValueError, match=what):
            step(p, o, ids, ids)
    finally:
        dist.destroy_process_group()


def test_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.build_train_step(tm.ernie_moe_fine_tiny())


def test_presets_match_jax():
    for jc, tc in ((jm.ernie_moe_fine(), tm.ernie_moe_fine()),
                   (jm.ernie_moe_fine_tiny(), tm.ernie_moe_fine_tiny()),
                   (jm.ernie_moe_tiny(), tm.ernie_moe_tiny())):
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads", "num_experts",
                  "moe_topk", "num_shared_experts", "capacity_factor",
                  "moe_every",
                  "aux_loss_weight", "max_position_embeddings",
                  "layer_norm_eps", "dispatch_mode"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    # the port's own init has the JAX tree's names, shapes and dtypes
    cfg = jm.ernie_moe_fine_tiny()
    want = _flat(_np_tree(jm.init_params(cfg)))
    got = tm.init_params(tm.ernie_moe_fine_tiny(), device="cpu")
    got_flat = {k: v for k, v in _flat(got).items()}
    assert want.keys() == got_flat.keys()
    for k in want:
        assert want[k].shape == got_flat[k].shape, k
    assert got["layers"]["moe"]["gate"].dtype == torch.float32
