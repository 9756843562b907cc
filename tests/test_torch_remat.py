"""Port parity: the rest of single-device Llama training in paddle_tpu_torch
(the remat policies, plain attention, chunked cross entropy, the
llama_13b preset) against paddle_tpu's, on the CPU.

The tiny fp32 Llama of ``tests/test_torch_train.py`` (2 layers, GQA 4/2,
head_dim 16, vocab 96, B 2, S 200), its weights drawn with numpy in
JAX's ``init_llama_params`` layout, goes through JAX (jitted; Pallas flash in interpret mode, or
``_xla_sdpa`` with ``use_flash=False``) and through the port (the
kernels' plain versions on CPU tensors). Tolerances are that file's: loss
1e-5 relative, gradients 1e-5 absolute (1e-4 relative), params after
three AdamW steps 5e-6 absolute. A remat policy changes only what the
backward recomputes, never a value, so each policy's loss and gradients
are held BITWISE to the port's own ``full``. Chunked cross entropy in f32:
loss 1e-5 relative, gradients 1e-5 of their largest magnitude, against
JAX's and against the port's dense loss (sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import flash_attention as fa

B, S = 2, 200
POLICIES = ["full", "dots", "save_attn", "save_mlp", "offload_attn"]
# full remat against JAX is tests/test_torch_train.py's
# test_loss_and_grads_match_jax[True]


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy} of a tree; a list of per-layer slices is stacked."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            out[prefix + k] = torch.stack(v).detach().numpy()
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def model():
    kw = dict(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
              seq=256)
    jcfg, tcfg = jl.llama_tiny(**kw), tl.llama_tiny(**kw)
    # JAX's init_llama_params layout, drawn with numpy: norms 1, the rest
    # N(0, 0.02)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.ones(a.shape, a.dtype)
                         if path[-1].key.endswith("norm")
                         else (rng.randn(*a.shape) * 0.02).astype(a.dtype)),
        jax.eval_shape(lambda: jl.init_llama_params(jcfg, seed=0)))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 96, size=(B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :17] = -100
    return jcfg, tcfg, params, ids, labels


class _Calls:
    """Counts the calls of the flash forward and backward (the plain
    versions run on the CPU; on the card each call is one launch)."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        fwd, bwd = fa.flash_fwd, fa.flash_bwd

        def count_fwd(*a, **k):
            self.fwd += 1
            return fwd(*a, **k)

        def count_bwd(*a, **k):
            self.bwd += 1
            return bwd(*a, **k)

        monkeypatch.setattr(fa, "flash_fwd", count_fwd)
        monkeypatch.setattr(fa, "flash_bwd", count_bwd)


def _port_grads(model, par):
    _, tcfg, params, ids, labels = model
    loss, grads = tl.llama_loss_and_grads(
        tl.params_from_numpy(params, "cpu"), torch.from_numpy(ids),
        torch.from_numpy(labels), tcfg, par)
    return loss, _flat(grads)


@pytest.fixture(scope="module")
def port_full(model):
    with _common.interpret_mode(True):
        return _port_grads(model, tl.ParallelConfig())


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policy_matches_jax_and_is_full_bitwise(model, port_full, policy,
                                                monkeypatch):
    jcfg, _, params, ids, labels = model
    jpar = jl.ParallelConfig(remat_policy=policy)

    @jax.jit
    def loss_and_grads(p, i, lab):
        return jax.value_and_grad(jl.llama_loss)(p, i, lab, jcfg, jpar, None,
                                                 True)

    loss_j, grads_j = loss_and_grads(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids),
        jnp.asarray(labels))
    calls = _Calls(monkeypatch)
    loss_t, grads_t = _port_grads(model, tl.ParallelConfig(
        remat_policy=policy))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = _flat(_np_tree(grads_j))
    assert want.keys() == grads_t.keys()
    for name in want:
        np.testing.assert_allclose(grads_t[name], want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    loss_f, grads_f = port_full
    assert torch.equal(loss_t, loss_f)
    for name in grads_f:
        assert np.array_equal(grads_t[name], grads_f[name]), name
    # the forward launches once a layer; dots launches it again in the
    # recompute, as full does, the policies that keep attn_out (and its
    # lse) do not
    L = jcfg.num_hidden_layers
    again = policy == "dots"
    assert (calls.fwd, calls.bwd) == ((2 if again else 1) * L, L)


def test_plain_attention_three_steps_match_jax(model, monkeypatch):
    """use_flash=False: JAX's _xla_sdpa branch against the port's, three
    build_train_step steps from the same weights and moments."""
    jcfg, tcfg, params, ids, labels = model
    step_j, _, _ = jl.build_train_step(
        jcfg, jl.ParallelConfig(use_flash=False))
    step_t, _, _ = tl.build_train_step(
        tcfg, tl.ParallelConfig(use_flash=False), device="cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_j = jl._adamw_init(p_j)
    p_t = tl.params_from_numpy(params, "cpu")
    opt_t = tl.params_from_numpy(_np_tree(opt_j), "cpu")
    calls = _Calls(monkeypatch)
    losses_j, losses_t = [], []
    for _ in range(3):
        p_j, opt_j, loss_j = step_j(p_j, opt_j, ids, labels)
        p_t, opt_t, loss_t = step_t(p_t, opt_t, ids, labels)
        losses_j.append(float(loss_j))
        losses_t.append(float(loss_t))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[2] < losses_t[0]
    want, got = _flat(_np_tree(p_j)), _flat(p_t)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-6, rtol=0,
                                   err_msg=name)
    assert (calls.fwd, calls.bwd) == (0, 0)


def test_plain_attention_under_each_policy_is_full_bitwise(model):
    """With use_flash=False, 'attn_out' names the copy that lays the plain
    attention out as [B, S, NH*HD]: each policy is the port's plain full
    remat, bit for bit."""
    base = _port_grads(model, tl.ParallelConfig(use_flash=False))
    for policy in POLICIES[1:]:
        loss, grads = _port_grads(model, tl.ParallelConfig(
            use_flash=False, remat_policy=policy))
        assert torch.equal(loss, base[0]), policy
        for name in grads:
            assert np.array_equal(grads[name], base[1][name]), (policy, name)


def test_unknown_policy_raises_as_jax(model):
    tcfg = model[1]
    with pytest.raises(ValueError) as want:
        jl._remat_policy(jl.ParallelConfig(remat_policy="bogus"))
    with pytest.raises(ValueError) as got:
        tl.build_train_step(tcfg, tl.ParallelConfig(remat_policy="bogus"),
                            device="cpu")
    assert str(got.value) == str(want.value)
    # remat off never reads the policy, as in JAX
    tl.check_ported(tl.ParallelConfig(remat=False, remat_policy="bogus"))
    for policy in POLICIES:
        for use_flash in (None, True, False):
            tl.check_ported(tl.ParallelConfig(remat_policy=policy,
                                              use_flash=use_flash))


@pytest.mark.parametrize("s", [64, 63])
def test_chunked_ce_matches_jax_and_the_dense_loss(s):
    """x [2, S, 32] and head [32, 80] in f32, some labels -100; S = 63 pads
    to a multiple of the 8 chunks (tests/test_llama_decode.py:120)."""
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, 32).astype(np.float32)
    head = (rng.randn(32, 80) * 0.2).astype(np.float32)
    labels = rng.randint(0, 80, (2, s)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    loss_j, (dx_j, dh_j) = jax.jit(jax.value_and_grad(
        jl.chunked_ce_loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels))
    runs = {}
    for name, fn in (("chunked", lambda xs, hs, ls: tl.chunked_ce_loss(
                         xs, hs, ls)),
                     ("dense", lambda xs, hs, ls: tl.masked_ce_loss(
                         (xs @ hs).float(), ls))):
        xs = torch.from_numpy(x).requires_grad_()
        hs = torch.from_numpy(head).requires_grad_()
        loss = fn(xs, hs, torch.from_numpy(labels))
        loss.backward()
        runs[name] = (loss.detach(), xs.grad, hs.grad)
    for name, (loss, dx, dh) in runs.items():
        assert loss.dtype == torch.float32 and loss.ndim == 0
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5,
                                   err_msg=name)
        for g, w in ((dx, dx_j), (dh, dh_j)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
    # padded rows get no gradient
    assert runs["chunked"][1].shape == x.shape


def test_llama_13b_matches_jax():
    jc, tc = jl.llama_13b(), tl.llama_13b()
    fields = [f.name for f in dataclasses.fields(tl.LlamaConfig)]
    assert fields == [f.name for f in dataclasses.fields(jl.LlamaConfig)]
    for f in fields:
        if f != "dtype":
            assert getattr(tc, f) == getattr(jc, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert tc.head_dim == jc.head_dim == 128
    assert tl.count_params(tc) == jl.count_params(jc)
    assert tl.train_flops_per_token(tc, 2048) == \
        jl.train_flops_per_token(jc, 2048)
