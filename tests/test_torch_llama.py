"""Port parity: paddle_tpu_torch/models/llama.py paged steps against
paddle_tpu/models/llama.py on a tiny fp32 Llama (2 layers, GQA 4/2,
head_dim 16), weights moved through numpy by ``params_from_numpy``.
The JAX side runs its Pallas kernels in interpret mode; the port runs
its kernels' plain versions on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common

from paddle_tpu_torch.models import llama as tl

BS, NP, MAX_NB = 128, 8, 4


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(scope="module")
def model():
    jcfg = jl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         seq=512)
    tcfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         seq=512)
    params = jl.init_llama_params(jcfg, seed=5)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tparams


def _pools(cfg, seed):
    rng = np.random.RandomState(seed)
    kvd = cfg.num_key_value_heads * cfg.head_dim
    shape = (cfg.num_hidden_layers, NP, kvd, BS)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _check_pools(got, want):
    for g, w in zip(got, want):
        # block 0 is the null block dead tokens / padding rows scribble on
        np.testing.assert_allclose(g.numpy()[:, 1:], np.asarray(w)[:, 1:],
                                   atol=1e-5)


def test_config_and_params_layout(model):
    jcfg, params, tcfg, tparams = model
    assert tcfg.head_dim == jcfg.head_dim
    c7 = tl.llama_7b()
    assert (c7.hidden_size, c7.num_hidden_layers, c7.num_attention_heads,
            c7.num_key_value_heads, c7.head_dim, c7.vocab_size,
            c7.dtype) == (4096, 32, 32, 32, 128, 32000, torch.bfloat16)
    ours = tl.init_llama_params(tcfg, seed=0, device="cpu")
    flat = lambda t: {k: v.shape for k, v in t["layers"].items()}
    assert flat(ours) == {k: tuple(v.shape)
                          for k, v in params["layers"].items()}
    assert ours["embed"].shape == params["embed"].shape
    assert ours["lm_head"].shape == params["lm_head"].shape
    again = tl.init_llama_params(tcfg, seed=0, device="cpu")
    assert torch.equal(ours["layers"]["q_proj"], again["layers"]["q_proj"])


def test_params_from_numpy_bf16():
    a = jnp.asarray(np.linspace(-2, 2, 12).reshape(3, 4), jnp.bfloat16)
    t = tl.params_from_numpy({"w": np.asarray(a)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_prefill_chunk_matches_jax(model):
    """A chunk over a cached prefix that straddles into a fresh block,
    with dead padding tokens past n_live."""
    jcfg, params, tcfg, tparams = model
    kp, vp = _pools(jcfg, 0)
    table = np.asarray([3, 5, 0, 0], np.int32)
    ids = np.zeros((32,), np.int32)
    ids[:20] = np.random.RandomState(1).randint(1, 96, size=20)
    start, n_live = 120, 20
    ref = jl.llama_paged_prefill_chunk(
        params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.int32(start), jnp.asarray(ids), jnp.int32(n_live), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, tk, tv = tl.llama_paged_prefill_chunk(
        tparams, tk, tv, torch.from_numpy(table), start,
        torch.from_numpy(ids), n_live, tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref[0]), atol=1e-4)
    _check_pools((tk, tv), ref[1:])


def test_decode_step_matches_jax(model):
    """Ragged rows, one opening a fresh block, one padding row."""
    jcfg, params, tcfg, tparams = model
    kp, vp = _pools(jcfg, 2)
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0], [2, 6, 0, 0],
                         [7, 0, 0, 0]], np.int32)
    positions = np.asarray([140, 0, 128, 9], np.int32)
    ids = np.asarray([4, 0, 17, 88], np.int32)
    ref = jl.llama_paged_decode_step(
        params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(ids), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, tk, tv = tl.llama_paged_decode_step(
        tparams, tk, tv, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(ids), tcfg)
    live = positions != 0
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(ref[0])[live], atol=1e-4)
    _check_pools((tk, tv), ref[1:])


def test_paged_steps_take_int8_weights(model):
    """The decode step and the prefill chunk (the speculative draft's
    steps too) on weight-only int8 ``{'w', 's'}`` weights."""
    jcfg, params, tcfg, _ = model
    qparams = jl.quantize_llama_int8(params)
    tq = tl.params_from_numpy(jax.tree.map(np.asarray, qparams), "cpu")
    kp, vp = _pools(jcfg, 3)
    tables = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    positions = np.asarray([130, 0], np.int32)
    ids = np.asarray([4, 0], np.int32)
    ref = jl.llama_paged_decode_step(
        qparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(ids), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, tk, tv = tl.llama_paged_decode_step(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(positions),
        torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(logits.numpy()[:1], np.asarray(ref[0])[:1],
                               atol=1e-4)
    _check_pools((tk, tv), ref[1:])
    chunk = np.zeros((16,), np.int32)
    chunk[:9] = np.arange(1, 10)
    ref = jl.llama_paged_prefill_chunk(
        qparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables[0]),
        jnp.int32(125), jnp.asarray(chunk), jnp.int32(9), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, tk, tv = tl.llama_paged_prefill_chunk(
        tq, tk, tv, torch.from_numpy(tables[0]), 125,
        torch.from_numpy(chunk), 9, tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref[0]), atol=1e-4)
    _check_pools((tk, tv), ref[1:])


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tl.llama_tiny(layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_llama_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_paged_kv_pool(cfg, 4, 128)
