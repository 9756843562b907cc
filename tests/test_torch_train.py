"""Port parity: the single-GPU Llama train step of paddle_tpu_torch against
paddle_tpu's, on the CPU.

A tiny fp32 Llama (2 layers, GQA 4/2, head_dim 16, vocab 96) with JAX's
``init_llama_params`` weights, carried across by ``params_from_numpy``,
goes through JAX (Pallas flash in interpret mode, ``use_flash=True``) and
through the port, whose kernels run their plain PyTorch versions on CPU
tensors. Tolerances (f32, sums in another order): loss 1e-5 relative,
gradients 1e-5 absolute on values of order 1e-2, params after three AdamW
steps 5e-6 absolute: an update moves a param by about lr = 3e-4, and a
param whose gradient is near zero moves by m / sqrt(v), where f32 noise in
the gradient shows most (one such param of 16,384 differs by 1.3e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common
from paddle_tpu.ops.rms_norm import fused_rms_norm as jax_rms_norm

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops.rms_norm import fused_rms_norm

B, S = 2, 200


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
            out[prefix + k] = torch.stack(v).detach().float().numpy()
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().float().numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def model():
    jcfg = jl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         inter=128, seq=256)
    tcfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         inter=128, seq=256)
    params = _np_tree(jl.init_llama_params(jcfg, seed=0))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 96, size=(B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :17] = -100
    return jcfg, tcfg, params, ids, labels


def test_rms_norm_grad_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    g = rng.randn(6, 5, 64).astype(np.float32)
    with _common.interpret_mode(True):
        out_j, pull = jax.vjp(lambda x, w: jax_rms_norm(x, w, 1e-5),
                              jnp.asarray(x), jnp.asarray(w))
        dx_j, dw_j = pull(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fused_rms_norm(xt, wt, 1e-5)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j),
                               rtol=1e-5, atol=1e-5)


def test_rms_norm_builds_a_graph_only_when_a_gradient_is_tracked():
    """The serving steps (no grad) skip the autograd Function; the values
    are the same either way."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    w = torch.from_numpy(rng.randn(64).astype(np.float32))
    plain = fused_rms_norm(x, w, 1e-5)
    with torch.no_grad():
        off = fused_rms_norm(x, w.requires_grad_(), 1e-5)
    tracked = fused_rms_norm(x, w, 1e-5)
    assert plain.grad_fn is None and off.grad_fn is None
    assert tracked.grad_fn is not None
    assert torch.equal(plain, off) and torch.equal(plain, tracked.detach())


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(model, remat):
    jcfg, tcfg, params, ids, labels = model
    loss_j, grads_j = jax.value_and_grad(jl.llama_loss)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids),
        jnp.asarray(labels), jcfg, jl.ParallelConfig(remat=remat), None,
        True)
    tparams = tl.params_from_numpy(params, "cpu")
    loss_t, grads_t = tl.llama_loss_and_grads(
        tparams, torch.from_numpy(ids), torch.from_numpy(labels), tcfg,
        tl.ParallelConfig(remat=remat))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want, got = _flat(_np_tree(grads_j)), _flat(grads_t)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    # the loss alone, without autograd, is the same number
    with torch.no_grad():
        again = tl.llama_loss(tparams, torch.from_numpy(ids),
                              torch.from_numpy(labels), tcfg)
    assert float(again) == pytest.approx(float(loss_t), rel=1e-6)


@pytest.mark.parametrize("multi_precision,dtype", [
    (True, np.float32), (False, np.float32), (False, "bfloat16")])
def test_adamw_update_matches_jax(multi_precision, dtype):
    rng = np.random.RandomState(4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    shapes = {"stack": (3, 8, 40), "mat": (70, 16), "vec": (16,)}
    params = {k: jnp.asarray(rng.randn(*s), jdt) for k, s in shapes.items()}
    grads = {k: jnp.asarray(rng.randn(*s) * 1e-2, jdt)
             for k, s in shapes.items()}
    masks = {"stack": jnp.asarray([True, False, True]),
             "mat": None, "vec": None}
    st_j = jl._adamw_init(params, multi_precision)
    p_j = params
    tp = tl.params_from_numpy(_np_tree(params), "cpu")
    st_t = tl._adamw_init(tp, multi_precision)
    for name, want in _flat(_np_tree(st_j)).items():
        got = _flat(st_t)[name]
        assert got.shape == want.shape and not got.any(), name
    assert {k: v.dtype for k, v in st_t["m"].items()} == {
        k: v.dtype for k, v in
        tl.params_from_numpy(_np_tree(st_j["m"]), "cpu").items()}
    tmasks = {"stack": torch.tensor([True, False, True]), "mat": None,
              "vec": None}
    for step in range(3):
        g_np = _np_tree(grads) if step else _np_tree(
            jax.tree_util.tree_map(lambda g: g * 3, grads))
        g_j = jax.tree_util.tree_map(jnp.asarray, g_np)
        p_j, st_j = jl._adamw_update(p_j, g_j, st_j, 3e-4,
                                     masks=masks if step == 1 else None)
        gt = tl.params_from_numpy(g_np, "cpu")
        # the stacked leaf's gradient as per-layer slices, as the train
        # step hands it over
        gt["stack"] = list(gt["stack"])
        tp, st_t = tl._adamw_update(tp, gt, st_t, 3e-4,
                                    masks=tmasks if step == 1 else None)
    tol = dict(rtol=0, atol=1e-7) if dtype == np.float32 else \
        dict(rtol=2.0 ** -7, atol=0)
    for name, want in _flat(_np_tree({"p": p_j, "m": st_j["m"],
                                      "v": st_j["v"]})).items():
        got = _flat({"p": tp, "m": st_t["m"], "v": st_t["v"]})[name]
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   err_msg=name, **tol)
    assert float(st_t["t"]) == float(st_j["t"]) == 3.0
    assert st_t["m"]["mat"].dtype == (torch.float32 if multi_precision
                                      else tp["mat"].dtype)


def test_build_train_step_three_steps_match_jax(model):
    """Three steps of each framework's build_train_step from the same
    weights and moments: every loss, then every param."""
    jcfg, tcfg, params, ids, labels = model
    step_j, p_j, opt_j = jl.build_train_step(
        jcfg, jl.ParallelConfig(use_flash=True, remat=True))
    step_t, _, _ = tl.build_train_step(tcfg, tl.ParallelConfig(remat=True),
                                       device="cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_j = jl._adamw_init(p_j)
    p_t = tl.params_from_numpy(params, "cpu")
    opt_t = tl.params_from_numpy(_np_tree(opt_j), "cpu")
    losses_j, losses_t = [], []
    for _ in range(3):
        p_j, opt_j, loss_j = step_j(p_j, opt_j, ids, labels)
        p_t, opt_t, loss_t = step_t(p_t, opt_t, ids, labels)
        losses_j.append(float(loss_j))
        assert loss_t.dtype == torch.float32 and loss_t.ndim == 0
        losses_t.append(float(loss_t))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[2] < losses_t[0]
    want, got = _flat(_np_tree(p_j)), _flat(p_t)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-6,
                                   rtol=0, err_msg=name)
    assert float(opt_t["t"]) == 3.0


def test_params_from_numpy_carries_opt_state(model):
    jcfg, _, params, _, _ = model
    opt = _np_tree(jl._adamw_init(jax.tree_util.tree_map(jnp.asarray,
                                                         params)))
    opt["m"]["embed"] = opt["m"]["embed"] + 0.5
    t = tl.params_from_numpy(opt, "cpu")
    assert t["t"].shape == () and t["t"].dtype == torch.float32
    assert t["m"]["layers"]["q_proj"].shape == \
        params["layers"]["q_proj"].shape
    assert float(t["m"]["embed"][0, 0]) == 0.5
    assert t["v"]["lm_head"].dtype == torch.float32


@pytest.mark.parametrize("kwargs,what", [
    (dict(dp=2), "dp"),
    (dict(mp=2), "mp"),
    (dict(sharding=2), "sharding"),
    (dict(sep=2), "sep"),
    (dict(pp=2), "pp"),
    (dict(use_flash=False), "use_flash"),
    (dict(remat_policy="dots"), "dots"),
    (dict(remat_policy="save_attn"), "save_attn"),
    # fields the single-device step never reads
    (dict(microbatches=4), "microbatches"),
    (dict(scan_unroll=2), "scan_unroll"),
    (dict(zero_stage=1), "zero_stage"),
    (dict(sep_strategy="ulysses"), "sep_strategy"),
    (dict(overlap_p2p=True), "overlap_p2p"),
])
def test_unported_parallel_configs_raise(model, kwargs, what):
    tcfg = model[1]
    with pytest.raises(ValueError, match=what):
        tl.build_train_step(tcfg, tl.ParallelConfig(**kwargs), device="cpu")


def test_remat_off_ignores_policy_and_device_none_needs_cuda(model):
    tcfg = model[1]
    tl.check_ported(tl.ParallelConfig(remat=False, remat_policy="dots"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.build_train_step(tcfg, tl.ParallelConfig())


def test_flops_accounting_matches_jax():
    for jc, tc in ((jl.llama_7b(), tl.llama_7b()),
                   (jl.llama_tiny(), tl.llama_tiny())):
        assert tl.count_params(tc) == jl.count_params(jc)
        assert tl.train_flops_per_token(tc, 2048) == \
            jl.train_flops_per_token(jc, 2048)
