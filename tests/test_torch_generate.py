"""Port parity: generation (paddle_tpu_torch/models/llama.py ``generate``
and what it runs, ops/decode_attention.py) against paddle_tpu.

Two tiny fp32 Llamas, GQA 2/1, weights moved through numpy: head_dim 32
(the slab cache; T a multiple of 128 takes the fused attend+update kernel,
a ragged T the einsum branch) and head_dim 128 (the head-major cache).
The JAX side runs as its own tests run it, Pallas in interpret mode on the
CPU, jitted; the port runs its kernels' plain versions on the CPU. The
CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
``python3 chip_smoke.py``).

Tolerances: f32 attention, logits and caches within 1e-5 (sums in another
order); greedy and beam streams token-identical; int8 codes and scales
bitwise. The port's kernels take per-head q [B, NH, HD]; the JAX kernels
a block-diagonal [B, NH, KVD], so the tests build that for JAX and read
its diagonal blocks back.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.nn.quant import absmax_intq as jax_absmax_intq
from paddle_tpu.ops import _common
from paddle_tpu.ops import decode_attention as jda

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import decode_attention as tda

LOG2E = 1.4426950408889634
SLAB = dict(vocab=64, hidden=64, layers=2, heads=2, kv_heads=1, inter=64,
            seq=512)                                   # head_dim 32
HEAD_MAJOR = dict(SLAB, hidden=256)                    # head_dim 128
PROMPT = np.random.RandomState(0).randint(0, 64, (2, 126)).astype(np.int32)


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@functools.lru_cache(maxsize=None)
def _model(kind):
    kw = SLAB if kind == "slab" else HEAD_MAJOR
    jcfg, tcfg = jl.llama_tiny(**kw), tl.llama_tiny(**kw)
    # seeded weights made by the port (the JAX init compiles op by op);
    # both sides get the same values
    tparams = tl.init_llama_params(tcfg, seed=1, device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, params, tcfg, tparams


# ---------------------------------------------------------------------------
# kernels (rows 10, 11, 12)
# ---------------------------------------------------------------------------

def _slab_case(nh, nkv, hd, T=256, B=2, L=2, seed=0):
    rng = np.random.RandomState(seed)
    kvd = nkv * hd
    q = (rng.randn(B, nh, hd) * (LOG2E / hd ** 0.5)).astype(np.float32)
    return (q, rng.randn(B, kvd).astype(np.float32),
            rng.randn(B, kvd).astype(np.float32),
            rng.randn(L, B, kvd, T).astype(np.float32),
            rng.randn(L, B, kvd, T).astype(np.float32))


def _block_diag(q, nkv):
    b, nh, hd = q.shape
    eye = np.eye(nkv, dtype=np.float32)
    return np.einsum("bgrd,ge->bgred", q.reshape(b, nkv, nh // nkv, hd),
                     eye).reshape(b, nh, nkv * hd)


def _diag_blocks(out, nkv, hd):
    b, nh, _ = out.shape
    eye = np.eye(nkv, dtype=np.float32)
    return np.einsum("bgred,ge->bgrd", np.asarray(out).reshape(
        b, nkv, nh // nkv, nkv, hd), eye).reshape(b, nh, hd)


@functools.lru_cache(maxsize=None)
def _jax_slab(mode):
    """Both JAX kernels in one jit: the update at layer 1, then the
    read-only kernel on the caches as they were. Traced at its first call,
    under the softmax mode the caller has set, so one per mode."""
    def both(qbd, nk, nv, kc, vc, pos):
        out, k2, v2 = jda.decode_attend_update_slab(qbd, nk, nv, kc, vc, 1,
                                                    pos)
        return out, k2, v2, jda.decode_attention_slab(qbd, kc, vc, 1, pos)
    return jax.jit(both)


def _check_slab(monkeypatch, mode, nh, nkv, hd, positions, case=None):
    """Rows 10 and 11's plain versions against the JAX kernels at each
    position: attention on the diagonal blocks within 1e-5, the written
    caches bitwise."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, nk, nv, kc, vc = case or _slab_case(nh, nkv, hd)
    args = [jnp.asarray(a) for a in (_block_diag(q, nkv), nk, nv, kc, vc)]
    for pos in positions:
        ref, rk, rv, ref_ro = _jax_slab(mode)(*args, pos)
        kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        got_ro = tda.decode_attention_slab(torch.from_numpy(q), kt, vt, 1, pos)
        assert np.array_equal(kt.numpy(), kc)
        got = tda.decode_attend_update_slab(
            torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
            kt, vt, 1, pos)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(kt.numpy()[1, :, :, pos], nk)
        for g, r in ((got, ref), (got_ro, ref_ro)):
            np.testing.assert_allclose(g.numpy(), _diag_blocks(r, nkv, hd),
                                       atol=1e-5, rtol=0)


# (NH, NKV, HD): rep 1, 2 and 8 at head_dim 64 and 8; T = 256 is two
# tiles, so pos 0, the tile edge 127/128 and T - 1 = 255
POSITIONS = (0, 127, 128, 255)


@pytest.mark.parametrize("shape", [(2, 2, 64), (4, 2, 8), (8, 1, 64)])
def test_slab_kernels_match_jax_online(monkeypatch, shape):
    _check_slab(monkeypatch, "online", *shape, POSITIONS)


def test_slab_kernels_match_jax_fixed_base(monkeypatch):
    """The JAX default's tile-0-anchored softmax gives the same result
    wherever it does not overflow."""
    _check_slab(monkeypatch, "auto", 8, 1, 64, POSITIONS)


def test_slab_update_adversarial_spread(monkeypatch):
    """Tile 1's scores lead tile 0's by more than 130 log2 units: the
    online recurrence (the port's only mode) still matches JAX's online
    mode."""
    q, nk, nv, kc, vc = _slab_case(4, 2, 8)
    kc[:, :, :, 128:] *= 150.0
    s = np.einsum("bgrd,bgdt->bgrt", q.reshape(2, 2, 2, 8),
                  kc[1].reshape(2, 2, 8, 256))
    assert (s[..., 128:].max(-1) - s[..., :128].max(-1)).max() > 130
    _check_slab(monkeypatch, "online", 4, 2, 8, (200, 255),
                (q, nk, nv, kc, vc))


def test_pair_kernel_function_is_row_11():
    """Row 12 (``_decode_attention_slab_pair``, two head_dim-64 heads per
    128-lane band, MHA) computes row 11's function on the diagonal
    blocks: the port's row-11 version matches it."""
    q, _, _, kc, vc = _slab_case(4, 4, 64)
    ref = jax.jit(lambda *a: jda._decode_attention_slab_pair(*a))(
        jnp.asarray(_block_diag(q, 4)), jnp.asarray(kc), jnp.asarray(vc),
        1, 200)
    got = tda.decode_attention_slab(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc), 1, 200)
    np.testing.assert_allclose(got.numpy(), _diag_blocks(ref, 4, 64),
                               atol=1e-5, rtol=0)


def test_slab_kernel_wrappers_reject_bad_inputs():
    q, nk, nv, kc, vc = (torch.from_numpy(a) for a in _slab_case(4, 2, 8))
    with pytest.raises(ValueError, match="multiple of 128"):
        tda.decode_attention_slab(q, kc[..., :200].contiguous(),
                                  vc[..., :200].contiguous(), 0, 5)
    with pytest.raises(ValueError, match="outside"):
        tda.decode_attend_update_slab(q, nk, nv, kc, vc, 0, 256)
    with pytest.raises(TypeError):
        tda.decode_attention_slab(q.double(), kc, vc, 0, 5)
    with pytest.raises(ValueError, match="NH/NKV"):
        tda.decode_attention_slab(q[:, :3].contiguous(), kc, vc, 0, 5)


# ---------------------------------------------------------------------------
# cache, prefill, decode step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode(frozen):
    cfg = jl.LlamaConfig(*frozen)
    return jax.jit(lambda p, c, i: jl.llama_decode_step(p, c, i, cfg))


@pytest.mark.parametrize("kind,T", [("slab", 256), ("slab", 200),
                                    ("head_major", 256)])
def test_prefill_and_decode_steps_match_jax(kind, T):
    """init_kv_cache's layout, the prefill over a prompt crossing a tile
    edge, then three decode steps: logits and caches within 1e-5."""
    jcfg, params, tcfg, tparams = _model(kind)
    frozen = jl._freeze_config(jcfg)
    jcache = jl.init_kv_cache(jcfg, 2, T)
    tcache = tl.init_kv_cache(tcfg, 2, T, device="cpu")
    assert tcache["k"].shape == jcache["k"].shape and tcache["pos"] == 0
    jlog, jcache = jl._jitted_prefill(frozen)(params, jcache,
                                              jnp.asarray(PROMPT))
    tlog, tcache = tl.llama_prefill(tparams, tcache, torch.from_numpy(PROMPT),
                                    tcfg)
    ids = np.random.RandomState(1).randint(0, 64, (3, 2, 1)).astype(np.int32)
    for step in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), atol=1e-5)
        assert tcache["pos"] == int(jcache["pos"]) == 126 + step
        if step < 3:
            jlog, jcache = _jax_decode(frozen)(params, jcache,
                                               jnp.asarray(ids[step]))
            tlog, tcache = tl.llama_decode_step(
                tparams, tcache, torch.from_numpy(ids[step]), tcfg)


def test_decode_step_branches_count_kernel_launches_only_on_card():
    """On the CPU the slab branch runs the plain version: no launch."""
    _, _, tcfg, tparams = _model("slab")
    before = tda.decode_attend_update_slab.launches
    cache = tl.init_kv_cache(tcfg, 1, 128, device="cpu")
    tl.llama_decode_step(tparams, cache, torch.tensor([[3]], dtype=torch.int32),
                         tcfg)
    assert tda.decode_attend_update_slab.launches == before


# ---------------------------------------------------------------------------
# greedy and beam streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["slab", "head_major"])
def test_greedy_generate_matches_jax(kind):
    """A 126-token prompt and 6 new tokens (not a power of two) cross the
    128 boundary of the cache mid-stream."""
    jcfg, params, tcfg, tparams = _model(kind)
    ref = jl.greedy_generate(params, PROMPT, jcfg, 6)
    got = tl.greedy_generate(tparams, PROMPT, tcfg, 6, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tl.greedy_generate(tparams, PROMPT, tcfg, 1, device="cpu"), ref[:, :1])


def test_greedy_generate_edge_cases():
    """The JAX package's edge cases (tests/test_llama_decode.py)."""
    _, _, tcfg, tparams = _model("slab")
    prompt = np.array([[1, 2]], np.int32)
    assert tl.greedy_generate(tparams, prompt, tcfg, 0,
                              device="cpu").shape == (1, 0)
    with pytest.raises(ValueError, match="overflow"):
        tl.greedy_generate(tparams, prompt, tcfg, 5, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        tl.greedy_generate(tparams, np.zeros((1, 0), np.int32), tcfg, 2,
                           device="cpu")


@pytest.mark.parametrize("kind,eos,penalty", [("slab", 3, 0.6),
                                              ("head_major", None, 0.0)])
def test_beam_search_matches_jax(monkeypatch, kind, eos, penalty):
    """Sequences identical, scores within 1e-5; every top-k cut the port
    makes has a gap above 1e-5 between its k-th and (k+1)-th candidate,
    so f32 noise cannot reorder the beams."""
    jcfg, params, tcfg, tparams = _model(kind)
    gaps = []

    def top_k(x, k):
        vals = torch.sort(x, dim=-1, descending=True).values
        gaps.append((vals[:, k - 1] - vals[:, k]).min().item())
        return tl_top_k(x, k)

    tl_top_k = tl._top_k
    monkeypatch.setattr(tl, "_top_k", top_k)
    ref_s, ref_sc = jl.beam_search_generate(params, PROMPT, jcfg, 5,
                                            num_beams=3, eos_token_id=eos,
                                            length_penalty=penalty)
    seqs, scores = tl.beam_search_generate(tparams, PROMPT, tcfg, 5,
                                           num_beams=3, eos_token_id=eos,
                                           length_penalty=penalty,
                                           device="cpu")
    assert len(gaps) == 5 and min(gaps) > 1e-5, gaps
    np.testing.assert_array_equal(seqs, ref_s)
    np.testing.assert_allclose(scores, ref_sc, atol=1e-5, rtol=0)
    assert (np.diff(scores, axis=1) <= 0).all()


# ---------------------------------------------------------------------------
# sampling and the generate entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 2, 1.0), (1.0, 0, 0.6), (0.8, 50, 0.9), (2.0, 0, 1.0)])
def test_sample_logits_keeps_the_token_set_of_jax(monkeypatch, temperature,
                                                  top_k, top_p):
    """The logits each side draws from: JAX's are caught at its
    ``jax.random.categorical`` call; the port's come from the same
    filter its sampler draws through."""
    rng = np.random.RandomState(4)
    logits = np.concatenate([
        np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32)),
        rng.randn(3, 4).astype(np.float32) * 3], axis=0)
    logits = np.tile(logits, (1, 20))[:, :64]
    caught = []

    def categorical(key, z, axis=-1):
        caught.append(np.asarray(z))
        return jnp.zeros(z.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jl.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                     temperature, top_k, top_p)
    z = tl._sample_filter(torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(z.numpy()),
                                  np.isfinite(caught[0]))
    live = np.isfinite(caught[0])
    np.testing.assert_allclose(z.numpy()[live], caught[0][live], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    draws = tl.sample_logits(torch.from_numpy(logits), gen, temperature,
                             top_k, top_p)
    assert live[np.arange(len(draws)), draws.numpy()].all()


def test_sample_generate_greedy_at_top_k_1_and_repeats_per_seed():
    _, _, tcfg, tparams = _model("slab")
    prompt = PROMPT[:, :20]
    greedy = tl.greedy_generate(tparams, prompt, tcfg, 7, device="cpu")
    np.testing.assert_array_equal(
        tl.sample_generate(tparams, prompt, tcfg, 7, top_k=1, device="cpu"),
        greedy)
    kw = dict(temperature=2.0, top_k=16, top_p=0.9, device="cpu")
    s1 = tl.sample_generate(tparams, prompt, tcfg, 7, seed=7, **kw)
    s2 = tl.sample_generate(tparams, prompt, tcfg, 7, seed=7, **kw)
    s3 = tl.sample_generate(tparams, prompt, tcfg, 7, seed=8, **kw)
    assert s1.shape == (2, 7) and s1.dtype == np.int32
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, s3)


def test_generate_dispatch_and_eos_guard():
    _, _, tcfg, tparams = _model("slab")
    prompt = PROMPT[:1, :9]
    run = functools.partial(tl.generate, tparams, prompt, tcfg, 5,
                            device="cpu")
    np.testing.assert_array_equal(
        run(), tl.greedy_generate(tparams, prompt, tcfg, 5, device="cpu"))
    assert run(decode_strategy="sampling", temperature=1.2, top_k=8,
               seed=4).shape == (1, 5)
    seqs, _ = tl.beam_search_generate(tparams, prompt, tcfg, 5, num_beams=3,
                                      device="cpu")
    np.testing.assert_array_equal(
        run(decode_strategy="beam_search", num_beams=3), seqs[:, 0])
    with pytest.raises(ValueError, match="decode_strategy"):
        run(decode_strategy="nope")
    with pytest.raises(ValueError, match="eos_token_id"):
        run(decode_strategy="sampling", eos_token_id=0)


def test_generation_needs_cuda_unless_cpu_named():
    _, _, tcfg, tparams = _model("slab")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.generate(tparams, PROMPT[:, :4], tcfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_kv_cache(tcfg, 1, 128)


# ---------------------------------------------------------------------------
# prepared and int8 weights
# ---------------------------------------------------------------------------

def test_prepare_decode_params_idempotent_equivalent_and_as_jax():
    jcfg, params, tcfg, tparams = _model("slab")
    prepared = tl.prepare_decode_params(tparams, tcfg)
    assert "qkv_proj" in prepared["layers"] and "q_proj" not in \
        prepared["layers"] and "q_proj" in tparams["layers"]
    assert tl.prepare_decode_params(prepared, tcfg) is prepared
    # JAX's prepared tree crosses through params_from_numpy unchanged
    jprep = jl.prepare_decode_params(jax.tree.map(jnp.array, params), jcfg)
    carried = tl.params_from_numpy(jax.tree.map(np.asarray, jprep), "cpu")
    assert torch.equal(carried["layers"]["qkv_proj"]["wT"],
                       prepared["layers"]["qkv_proj"]["wT"])
    prompt = PROMPT[:, :30]
    np.testing.assert_array_equal(
        tl.greedy_generate(prepared, prompt, tcfg, 5, device="cpu"),
        tl.greedy_generate(tparams, prompt, tcfg, 5, device="cpu"))
    # a head ratio the config does not match: three unfused {'wT'} stacks
    odd = dict(tparams, layers=dict(tparams["layers"],
                                    q_proj=tparams["layers"]["q_proj"][..., :32]))
    unfused = tl.prepare_decode_params(odd, tcfg)
    assert "qkv_proj" not in unfused["layers"]
    assert torch.equal(unfused["layers"]["q_proj"]["wT"],
                       odd["layers"]["q_proj"].transpose(-1, -2))
    assert tl.prepare_decode_params(unfused, tcfg) is unfused


def test_absmax_intq_bitwise_bf16():
    rng = np.random.RandomState(5)
    w = (rng.randn(3, 48, 40) * np.exp(rng.randn(3, 1, 40))).astype(
        jnp.bfloat16)
    jq, js = jax_absmax_intq(jnp.asarray(w), axis=-2)
    tq, ts = tl._absmax_intq(tl._tensor_from_numpy(w), axis=-2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_weights_bitwise_and_greedy_matches_jax():
    jcfg, params, tcfg, tparams = _model("head_major")
    jq = jl.quantize_llama_int8(params)   # eagerly, as callers run it
    tq = tl.quantize_llama_int8(tparams)
    carried = tl.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    for name in ("q_proj", "v_proj", "down_proj"):
        for leaf in ("w", "s"):
            assert torch.equal(tq["layers"][name][leaf],
                               carried["layers"][name][leaf])
    assert tq["lm_head"]["w"].dtype == torch.int8
    assert torch.equal(tq["lm_head"]["s"], carried["lm_head"]["s"])
    ref = jl.greedy_generate(jq, PROMPT, jcfg, 6)
    np.testing.assert_array_equal(
        tl.greedy_generate(tq, PROMPT, tcfg, 6, device="cpu"), ref)
