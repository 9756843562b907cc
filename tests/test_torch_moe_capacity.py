"""Port parity: the capacity slot schedule of paddle_tpu_torch's MoE (routing,
gating, stats, dispatch/combine) and ERNIE-MoE trained under it, on the
split and the non-split layer stacks, against paddle_tpu's, on the CPU.

Inputs are made with numpy and go through both packages; the JAX side is
jitted and runs Pallas in interpret mode, the port its plain PyTorch
versions (CPU tensors). Tolerances:
- routing, gating and stats on the same f32 logits: slots, dispatch masks
  and every stat bitwise (they are positions and counts); the gate weights,
  combine weights and the aux loss to 1e-6 relative (softmax's exp and the
  sums are each library's own);
- dispatch/combine in f32, port against JAX and slot form against one-hot
  form: 1e-5 (sums in another order);
- three ERNIE steps in f32: losses and lm_loss 1e-5 relative, stats
  bitwise; params within a tenth of the learning rate of JAX's on every
  element. AdamW divides each gradient by its own root mean square, so
  f32 noise in a near-zero gradient moves a param at the scale of lr,
  whatever the gradient's size. So one loss-and-gradients call is also
  held to ``jax.value_and_grad``: every leaf within 1e-5 of its largest
  element, 1e-4 relative.
Every router decision is checked to have a relative gap above 1e-5
between the k-th and (k+1)-th probability, so a flipped choice cannot
pass as a tolerance failure.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import ernie_moe as jm
from paddle_tpu.ops import _common
from paddle_tpu.parallel import moe as jmoe

from paddle_tpu_torch.models import ernie_moe as tm
from paddle_tpu_torch.models.llama import params_from_numpy
from paddle_tpu_torch.parallel import moe as tmoe

GAP = 1e-5
_j_route = jax.jit(jmoe.topk_route, static_argnums=(1, 2, 3))
_j_gating = jax.jit(jmoe.top_k_gating, static_argnums=(1, 2, 3))
_j_stats = jax.jit(jmoe.routing_stats, static_argnums=(1, 2, 3, 4))
_j_stats_oh = jax.jit(jmoe.routing_stats_onehot, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_MOE_DROPLESS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_TORCH_MOE_DROPLESS", raising=False)
    with _common.interpret_mode(True):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            out[prefix + k] = torch.stack(v).detach().float().numpy()
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().float().numpy()
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_gap(logits, k):
    p = np.sort(np.asarray(torch.softmax(torch.as_tensor(
        np.array(logits, np.float32)), -1)), -1)[:, ::-1]
    if k < p.shape[1]:
        gap = (p[:, k - 1] - p[:, k]) / p[:, k - 1]
        assert gap.min() > GAP, f"router gap {gap.min():.2e} at or below {GAP}"


# (name, T, E, k, capacity_factor, strict, skew): the skewed cases drop
# (empty_experts: 600 pairs over 4 live experts' 128-row buckets)
DROPS = ("overflow", "overflow_strict", "all_to_one_strict", "empty_experts")
ROUTES = [
    ("balanced", 320, 4, 2, 1.25, False, None),
    ("overflow", 320, 4, 2, 0.5, False, "plus2"),      # tests/test_moe.py:129
    ("overflow_strict", 320, 4, 2, 0.5, True, "plus2"),
    ("all_to_one_strict", 200, 2, 1, 1.0, True, "all_to_one"),  # :170
    ("empty_experts", 300, 8, 2, 1.25, False, "empty"),
    ("no_overflow_strict", 64, 4, 2, 8.0, True, None),  # :269
]


def _route_logits(seed, T, E, skew):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, E).astype(np.float32)
    if skew == "plus2":
        logits[:, 0] += 2.0
    elif skew == "all_to_one":
        logits[:, 0] += 9.0
    elif skew == "empty":
        logits[:, E // 2:] -= 30.0
    return logits


@pytest.mark.parametrize("T,k,E,cf", [
    (200, 1, 2, 1.0), (64, 2, 4, 1.25), (4096, 2, 8, 1.25),
    (16384, 4, 32, 1.25), (7, 2, 8, 0.5), (32, 2, 4, 0.1)])
def test_capacity_matches_jax(T, k, E, cf):
    assert tmoe.moe_capacity(T, k, E, cf) == jmoe.moe_capacity(T, k, E, cf)
    cap, ref = tmoe.moe_capacity(T, k, E, cf)
    assert cap % 128 == 0 and cap >= ref >= 1


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_topk_route_and_stats_match_jax(case):
    name, T, E, k, cf, strict, skew = case
    logits = _route_logits(3, T, E, skew)
    _assert_gap(logits, k)
    cap, ref = jmoe.moe_capacity(T, k, E, cf)
    drop = ref if strict else cap
    slot_j, w_j, aux_j = _j_route(jnp.asarray(logits), k, cap, drop)
    slot_t, w_t, aux_t = tmoe.topk_route(torch.from_numpy(logits), k, cap,
                                         drop_capacity=drop)
    assert slot_t.dtype == torch.int32
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    st_j = _j_stats(slot_j, E, cap, k, drop)
    st_t = tmoe.routing_stats(slot_t, E, cap, k, drop)
    assert st_j.keys() == st_t.keys()
    for key in st_j:
        np.testing.assert_array_equal(st_t[key].numpy(),
                                      np.asarray(st_j[key]), err_msg=key)
    dropped = float(st_t["moe_dropped_tokens"])
    assert (dropped > 0) == (name in DROPS)


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_top_k_gating_and_stats_match_jax(case):
    name, T, E, k, cf, strict, skew = case
    logits = _route_logits(4, T, E, skew)
    _assert_gap(logits, k)
    cap, ref = jmoe.moe_capacity(T, k, E, cf)
    drop = ref if strict else cap
    comb_j, disp_j, aux_j = _j_gating(jnp.asarray(logits), k, cap, drop)
    comb_t, disp_t, aux_t = tmoe.top_k_gating(torch.from_numpy(logits), k,
                                              cap, drop_capacity=drop)
    np.testing.assert_array_equal(disp_t.numpy(), np.asarray(disp_j))
    np.testing.assert_allclose(comb_t.numpy(), np.asarray(comb_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    st_j = _j_stats_oh(disp_j, k, drop)
    st_t = tmoe.routing_stats_onehot(disp_t, k, drop)
    assert st_j.keys() == st_t.keys()
    for key in st_j:
        np.testing.assert_array_equal(st_t[key].numpy(),
                                      np.asarray(st_j[key]), err_msg=key)
    # the slot schedule drops the same pairs
    slot_t, _, _ = tmoe.topk_route(torch.from_numpy(logits), k, cap,
                                   drop_capacity=drop)
    st_slot = tmoe.routing_stats(slot_t, E, cap, k, drop)
    for key in st_t:
        assert torch.equal(st_t[key], st_slot[key]), key


@pytest.mark.parametrize("mode", ["capacity", "ragged", "ragged_a2a"])
def test_zero_routing_stats_match_jax(mode):
    want = _np_tree(jmoe.zero_routing_stats(mode, 6))
    got = tmoe.zero_routing_stats(mode, 6)
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key])


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------

D, I = 16, 32


def _dispatch_inputs(case, seed=7):
    name, T, E, k, cf, strict, skew = case
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    logits = _route_logits(seed, T, E, skew)
    w1 = (rng.randn(E, D, I) * 0.1).astype(np.float32)
    w2 = (rng.randn(E, I, D) * 0.1).astype(np.float32)
    return x, logits, w1, w2


def _jax_dispatch(case, args, use_onehot):
    name, T, E, k, cf, strict, skew = case

    def expert_fn(params, toks):
        a, b = params
        return jax.nn.gelu(toks @ a) @ b

    def f(x, logits, w1, w2):
        out, aux, st = jmoe.moe_dispatch_combine(
            x, logits, expert_fn, (w1, w2), E, k=k, capacity_factor=cf,
            use_onehot=use_onehot, strict_capacity=strict,
            return_stats=True, dispatch_mode="capacity")
        return (out ** 2).sum() + aux, (out, st)

    (val, (out, st)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, args))
    return (float(val), np.asarray(out), _np_tree(st),
            [np.asarray(g) for g in grads])


def _port_dispatch(case, args, use_onehot):
    name, T, E, k, cf, strict, skew = case
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux, st = tmoe.moe_dispatch_combine(
        *leaves, E, k=k, capacity_factor=cf, use_onehot=use_onehot,
        strict_capacity=strict, return_stats=True, dispatch_mode="capacity")
    val = (out ** 2).sum() + aux
    val.backward()
    return (float(val.detach()), out.detach().numpy(),
            {key: v.numpy() for key, v in st.items()},
            [t.grad.numpy() for t in leaves])


DISPATCH = [r for r in ROUTES if r[0] in ("overflow", "all_to_one_strict",
                                          "balanced")]


@pytest.mark.parametrize("case", DISPATCH, ids=[r[0] for r in DISPATCH])
def test_dispatch_combine_matches_jax_in_both_forms(case):
    args = _dispatch_inputs(case)
    _assert_gap(args[1], case[3])
    runs = {}
    for onehot in (False, True):
        runs[("jax", onehot)] = _jax_dispatch(case, args, onehot)
        runs[("port", onehot)] = _port_dispatch(case, args, onehot)
    want = runs[("jax", False)]
    for key, got in runs.items():
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5,
                                   err_msg=str(key))
        assert got[2].keys() == want[2].keys()
        for s in want[2]:
            np.testing.assert_array_equal(got[2][s], want[2][s],
                                          err_msg=f"{key} {s}")
        for name, g, w in zip(("x", "logits", "w1", "w2"), got[3], want[3]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} d{name}")
    assert (want[2]["moe_dropped_tokens"] > 0) == (case[0] != "balanced")


def test_strict_capacity_drops_at_the_reference_capacity():
    """tests/test_moe.py's accounting: every token routes to expert 0, so
    its queue position is its index; the rounded bucket admits 128, the
    reference capacity 100, in both forms."""
    E, k, T = 2, 1, 200
    assert tmoe.moe_capacity(T, k, E, 1.0) == (128, 100)
    logits = torch.tensor([[9.0, 0.0]]).repeat(T, 1)
    x = torch.ones((T, 8))
    eye = torch.stack([torch.eye(8)] * E)
    outs = {}
    for strict in (False, True):
        for onehot in (False, True):
            outs[strict, onehot], _ = tmoe.moe_dispatch_combine(
                x, logits, eye, eye, E, k=k, capacity_factor=1.0,
                use_onehot=onehot, strict_capacity=strict,
                dispatch_mode="capacity", act=lambda t: t)
    for (strict, _), out in outs.items():
        alive = np.flatnonzero(out.abs().sum(-1).numpy() > 1e-6)
        n = 100 if strict else 128
        assert len(alive) == n and alive.max() == n - 1
    assert torch.equal(outs[True, False], outs[True, True])


def test_dispatch_mode_follows_the_knob_and_refuses_unknown_modes(
        monkeypatch):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(16, D).astype(np.float32))
    logits = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(4, D, I) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(4, I, D) * 0.1).astype(np.float32))
    for value, mode, key in (("", "capacity", "moe_capacity_util"),
                             ("1", "ragged", "moe_live_rows")):
        monkeypatch.setenv("PADDLE_TPU_TORCH_MOE_DROPLESS", value)
        monkeypatch.setenv("PADDLE_TPU_MOE_DROPLESS", value)
        assert tmoe.default_dispatch_mode() == mode == \
            jmoe.default_dispatch_mode()
        _, _, st = tmoe.moe_dispatch_combine(x, logits, w1, w2, 4,
                                             return_stats=True)
        assert key in st
    with pytest.raises(ValueError) as want:
        jmoe.moe_dispatch_combine(jnp.asarray(x.numpy()),
                                  jnp.asarray(logits.numpy()), None, None,
                                  4, dispatch_mode="bogus")
    with pytest.raises(ValueError) as got:
        tmoe.moe_dispatch_combine(x, logits, w1, w2, 4,
                                  dispatch_mode="bogus")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown dispatch_mode"):
        tm.build_train_step(tm.ernie_moe_tiny(), dispatch_mode="bogus",
                            device="cpu")


# ---------------------------------------------------------------------------
# ERNIE-MoE trained under capacity dispatch
# ---------------------------------------------------------------------------

# (name, config overrides, B, S): ernie_moe_tiny as it stands (split
# stacks, capacity by default); five layers at moe_every 2 (an odd count:
# non-split, layers 1 and 3 MoE); the non-split stack with every layer
# MoE (moe_every 1) over 2 experts, top-1, with the router skewed to
# expert 0 (_skew), so that 160 tokens overflow its 128-row bucket
ERNIE = [("tiny", {}, 2, 16),
         ("five_layers", dict(num_hidden_layers=5), 2, 16),
         ("every_layer_drops", dict(moe_every=1, num_experts=2, moe_topk=1),
          2, 80)]
LR = 3e-4           # both build_train_steps' default
SKEW_DIM = 5        # a hidden channel every token carries at a large value


def _skew(params):
    """Every router reads channel SKEW_DIM, raised by 0.1 in every
    embedding row (about 3 after RMSNorm), with weight 1 for expert 0: it
    takes nearly every token, far from a tie."""
    params["embed"] = params["embed"].copy()
    params["embed"][:, SKEW_DIM] += 0.1
    gate = params["layers"]["gate"].copy()
    gate[:, SKEW_DIM, 0] = 1.0
    params["layers"]["gate"] = gate
    return params


def _np_params(jcfg, seed):
    """Weights in the JAX ``init_params`` layout (shapes and dtypes from
    ``jax.eval_shape``), drawn with numpy: norms 1, the rest N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key.startswith(("ln", "final_ln")):
            return np.ones(leaf.shape, leaf.dtype)
        return (rng.randn(*leaf.shape) * 0.02).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: jm.init_params(jcfg)))


def _ernie_inputs(name, overrides, B, S):
    """Both configs, the numpy weights, ids and labels of one ERNIE case."""
    jcfg = dataclasses.replace(jm.ernie_moe_tiny(), **overrides)
    tcfg = dataclasses.replace(tm.ernie_moe_tiny(), **overrides)
    params = _np_params(jcfg, 0)
    if name == "every_layer_drops":
        params = _skew(params)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    return jcfg, tcfg, params, ids, labels


def _ernie_run(name, overrides, B, S):
    jcfg, tcfg, params, ids, labels = _ernie_inputs(name, overrides, B, S)
    step_j, _, _ = jm.build_train_step(jcfg, with_stats=True)
    step_t, _, _ = tm.build_train_step(tcfg, with_stats=True, device="cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    o_j = jm._adamw_init(p_j)
    p_t = params_from_numpy(params, "cpu")
    o_t = params_from_numpy(_np_tree(o_j), "cpu")
    seen = []
    route = tmoe.topk_route

    def recording_route(logits, *a, **kw):
        seen.append(logits.detach().numpy().copy())
        return route(logits, *a, **kw)

    out = {"j": [], "t": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "topk_route", recording_route)
        for _ in range(3):
            p_j, o_j, loss_j, st_j = step_j(p_j, o_j, ids, labels)
            p_t, o_t, loss_t, st_t = step_t(p_t, o_t, ids, labels)
            out["j"].append((float(loss_j), _np_tree(st_j)))
            out["t"].append((loss_t, {k: v.numpy()
                                      for k, v in st_t.items()}))
    return tcfg, seen, out, params, _np_tree(p_j), p_t, o_t


@pytest.mark.parametrize("case", ERNIE, ids=[e[0] for e in ERNIE])
def test_ernie_capacity_steps_match_jax(case):
    name, overrides, B, S = case
    cfg, seen, out, init, p_j, p_t, o_t = _ernie_run(name, overrides, B, S)
    assert tm.resolve_dispatch_mode(cfg) == "capacity"
    n_moe = sum(i % cfg.moe_every == cfg.moe_every - 1
                for i in range(cfg.num_hidden_layers))
    # the forward routes each MoE layer once a step; the non-split
    # stack's recompute routes it again
    split = name == "tiny"
    assert len(seen) == 3 * n_moe * (1 if split else 2)
    for logits in seen:
        _assert_gap(logits, cfg.moe_topk)
    for (loss_j, st_j), (loss_t, st_t) in zip(out["j"], out["t"]):
        assert loss_t.dtype == torch.float32 and loss_t.ndim == 0
        np.testing.assert_allclose(float(loss_t), loss_j, rtol=1e-5)
        assert st_j.keys() == st_t.keys()
        assert "moe_capacity_util" in st_t
        np.testing.assert_allclose(st_t["lm_loss"], st_j["lm_loss"],
                                   rtol=1e-5)
        for key in st_j:
            if key != "lm_loss":
                np.testing.assert_array_equal(st_t[key], st_j[key],
                                              err_msg=key)
        assert float(st_t["moe_routed_tokens"]
                     + st_t["moe_dropped_tokens"]) == \
            B * S * cfg.moe_topk * n_moe
        assert (float(st_t["moe_dropped_tokens"]) > 0) == \
            (name == "every_layer_drops")
    losses = [float(t[0]) for t in out["t"]]
    assert losses[2] < losses[0]
    want, got = _flat(p_j), _flat(p_t)
    assert want.keys() == got.keys() == _flat(init).keys()
    assert ("layers/dense/qkv" in got) == split
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=0.1 * LR,
                                   rtol=0, err_msg=key)
    assert float(o_t["t"]) == 3.0


@pytest.mark.parametrize("case", ERNIE, ids=[e[0] for e in ERNIE])
def test_ernie_capacity_grads_match_jax(case):
    """One loss-and-gradients call under capacity against
    ``jax.value_and_grad(moe_loss)``: the steps' params cannot show a
    gradient off by a constant positive factor (AdamW's update ignores
    it), this can. Every leaf within 1e-5 of its largest element (1e-4
    relative): the non-split stack's per-layer recompute, its dense
    layers' zero stats and the expert leaves a dense layer carries (their
    gradient exactly 0 in both) included."""
    name, overrides, B, S = case
    jcfg, tcfg, params, ids, labels = _ernie_inputs(*case)

    @jax.jit
    def loss_and_grads(p, i, lab):
        return jax.value_and_grad(jm.moe_loss, has_aux=True)(
            p, i, lab, jcfg, with_stats=True)

    (loss_j, (lm_j, st_j)), grads_j = loss_and_grads(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids),
        jnp.asarray(labels))
    loss_t, (lm_t, st_t), grads_t = tm.moe_loss_and_grads(
        params_from_numpy(params, "cpu"), torch.from_numpy(ids),
        torch.from_numpy(labels), tcfg, with_stats=True,
        dispatch_mode="capacity")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(lm_t), float(lm_j), rtol=1e-5)
    for key in st_j:
        np.testing.assert_array_equal(st_t[key].numpy(), np.asarray(st_j[key]),
                                      err_msg=key)
    want, got = _flat(_np_tree(grads_j)), _flat(grads_t)
    assert want.keys() == got.keys() == _flat(params).keys()
    for key in want:
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=key)
    if name != "tiny":
        # every layer carries both FFNs; the one a layer does not run gets
        # no gradient in either package, the other does
        moe = [i % tcfg.moe_every == tcfg.moe_every - 1
               for i in range(tcfg.num_hidden_layers)]
        for keys, unused in ((("gate", "e_w1", "e_w2"), np.logical_not(moe)),
                             (("w1", "w2"), np.array(moe))):
            for key in keys:
                w, g = want["layers/" + key], got["layers/" + key]
                assert not w[unused].any() and not g[unused].any(), key
                assert all(w[i].any() for i in np.flatnonzero(~unused)), key


def test_active_rows_under_capacity_raises_as_jax():
    cfg = dataclasses.replace(tm.ernie_moe_tiny(), moe_every=1)
    params = tm.init_params(cfg, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="active_rows requires"):
        tm.moe_loss(params, ids, ids, cfg, dispatch_mode="capacity",
                    active_rows=True)


def test_non_split_ragged_active_rows_freezes_dense_layers_experts():
    """On the non-split stack a ragged step's active-only masks cover all
    L layers: a dense layer routes no row, so its (unused) experts keep
    their params and moments, as in JAX's masks."""
    cfg = dataclasses.replace(tm.ernie_moe_fine_tiny(), num_hidden_layers=3)
    step, params, opt = tm.build_train_step(
        cfg, dispatch_mode="ragged", multi_precision=False, with_stats=True,
        active_only_moments=True, device="cpu")
    before = params["layers"]["e_w1"].clone()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    params, opt, loss, st = step(params, opt, ids, ids)
    after = params["layers"]["e_w1"]
    assert torch.equal(after[0], before[0]) and torch.equal(after[2],
                                                            before[2])
    assert not torch.equal(after[1], before[1])
    assert float(st["moe_routed_tokens"]) == 2 * 8 * cfg.moe_topk


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tm.ErnieMoEConfig)] == \
        [f.name for f in dataclasses.fields(jm.ErnieMoEConfig)]
    assert tm.ErnieMoEConfig().capacity_factor == \
        jm.ErnieMoEConfig().capacity_factor == 1.25


def test_init_params_non_split_layout_matches_jax():
    for field in (dict(moe_every=1), dict(num_hidden_layers=5),
                  dict(moe_every=3, num_hidden_layers=6)):
        jcfg = dataclasses.replace(jm.ernie_moe_fine_tiny(), **field)
        tcfg = dataclasses.replace(tm.ernie_moe_fine_tiny(), **field)
        want = jax.eval_shape(lambda: jm.init_params(jcfg))
        want = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), want)).items()}
        got = _flat(tm.init_params(tcfg, device="cpu"))
        assert want.keys() == got.keys()
        for k in want:
            assert want[k] == got[k].shape, k
