"""Port parity: the dense flash dispatch of
paddle_tpu_torch/ops/flash_attention.py (the backward knob, the split
pair, the block entries) against paddle_tpu/ops/flash_attention.py.

The same seeded numpy inputs go through JAX's functions, jitted, with
Pallas in interpret mode on the CPU, and through the port's CPU path, the
kernels' plain PyTorch versions. JAX's paths are selected as its own tests
select them: ``PADDLE_TPU_FLASH_BWD=split`` for its split pair (rows 17
and 18), ``STREAM_KV_BYTES`` patched to 0 for its streaming forward (row
13), and that plus ``_FLAT_BWD_VMEM_BUDGET`` patched to 0 under ``auto``
for its dQ-partials backward (row 15). The port's knob is
``PADDLE_TPU_TORCH_FLASH_BWD``.

Tolerances: f32 2e-5 absolute and relative (sums in another order, as in
tests/test_torch_flash.py); bf16 the rule of that file (elementwise
2^-6 of |ref| + the row's max |ref| + rms(ref), relative Frobenius
2^-10), where both sides round P and dS against the same lse.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common
from paddle_tpu.ops import flash_attention as jfa

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.delenv(fa.ENV_FLASH_BWD, raising=False)
    monkeypatch.delenv(jfa.ENV_FLASH_BWD, raising=False)
    with _common.interpret_mode(True):
        yield


def _mode(monkeypatch, mode):
    """The same backward mode in both packages."""
    monkeypatch.setenv(fa.ENV_FLASH_BWD, mode)
    monkeypatch.setenv(jfa.ENV_FLASH_BWD, mode)


def _bf16_close(name, got, want, rel=2 ** -6, frob=2 ** -10):
    g = torch.as_tensor(np.array(got, np.float32))
    r = torch.as_tensor(np.array(want, np.float32))
    diff = (g - r).abs()
    limit = rel * (r.abs() + r.abs().amax(-1, keepdim=True)
                   + r.square().mean().sqrt())
    assert (diff <= limit).all(), \
        f"{name}: {(diff - limit).max().item():.3e} over the limit"
    fro = (diff.norm() / r.norm()).item()
    assert fro <= frob, f"{name}: relative Frobenius error {fro:.3e}"


def _close(name, got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    else:
        _bf16_close(name, got, want)


def _np(t):
    return t.detach().float().numpy()


def _jnp(t):
    """A torch tensor as a JAX array of the same dtype (bf16 exact)."""
    x = jnp.asarray(_np(t))
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


def _inputs(bh, sq, sk, d, dtype, seed):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(bh, sq, d).astype(np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(bh, sk, d).astype(np.float32))
            .to(dtype) for _ in range(2))
    return q, k, v, do


# ---------------------------------------------------------------------------
# (a) the path JAX takes, (b) the knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "split"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [2048, 16384, 131072])
def test_schedule_stats_match_jax(monkeypatch, mode, d, s):
    _mode(monkeypatch, mode)
    for causal in (True, False):
        got = fa.dense_bwd_schedule_stats(8, s, s, d, torch.bfloat16, causal)
        want = jfa.dense_bwd_schedule_stats(8, s, s, d, jnp.bfloat16, causal)
        fwd_path = got.pop("fwd_path")
        assert got == want
        bq, bk = jfa._small_d_blocks(d, jfa.DEFAULT_BLOCK_Q,
                                     jfa.DEFAULT_BLOCK_K)
        skp = -(-s // jfa._fit_block(bk, s)) * jfa._fit_block(bk, s)
        streams = 2 * skp * d * 2 > jfa.STREAM_KV_BYTES
        assert fwd_path == ("stream" if streams else "resident")
    # the shapes the card runs name JAX's row 13 and row 15 paths
    if s >= 16384 and d == 128:
        assert fwd_path == "stream"
    if s == 131072 and d == 128:
        assert got["path"] == "fused_stream"


def test_bwd_mode_knob(monkeypatch):
    assert fa.dense_bwd_mode() == "auto"
    monkeypatch.setenv(fa.ENV_FLASH_BWD, " Split ")
    assert fa.dense_bwd_mode() == "split"
    monkeypatch.setenv(fa.ENV_FLASH_BWD, "fused")
    with pytest.raises(ValueError, match="PADDLE_TPU_TORCH_FLASH_BWD"):
        fa.dense_bwd_mode()
    q = torch.zeros(1, 8, 16, requires_grad=True)
    with pytest.raises(ValueError, match="PADDLE_TPU_TORCH_FLASH_BWD"):
        fa.flash_attention_bshd(q[None].transpose(1, 2), q[None]
                                .transpose(1, 2), q[None].transpose(1, 2)
                                ).sum().backward()


# ---------------------------------------------------------------------------
# (c) the split pair, (d) the streaming paths
# ---------------------------------------------------------------------------

def _fwd_stats(qs, k, v, do, causal):
    o, lse = fa.flash_fwd(qs, k, v, causal)
    return o, lse, (do.float() * o.float()).sum(-1)


def _jit(fn, static):
    """fn jitted through a new closure, so it is traced anew: JAX reads
    its path from the environment and module constants at trace time, and
    a jit of the same function object would reuse an earlier trace."""
    return jax.jit(lambda *a: fn(*a), static_argnums=static)


def _jax_bwd(qs, k, v, o, lse, do, causal, scale):
    return _jit(functools.partial(jfa._flash_bwd_pallas,
                                  block_q=jfa.DEFAULT_BLOCK_Q,
                                  block_k=jfa.DEFAULT_BLOCK_K,
                                  q_prescaled=True), (6, 7))(
        qs, k, v, o, lse, do, causal, scale)


# (Sq, Sk, causal, dtype, d); the last three: Sq != Sk with a kv tail
# that is no multiple of 128 (the card's dQ kernel takes 128-key stages),
# causal top-left at Sq < Sk, and D = 128
SPLIT_CASES = [(128, 128, True, torch.float32, 64),
               (200, 200, True, torch.float32, 16),
               (128, 256, False, torch.float32, 64),
               (192, 128, True, torch.float32, 16),
               (128, 128, True, torch.bfloat16, 64),
               (128, 256, False, torch.bfloat16, 64),
               (160, 300, True, torch.float32, 64),
               (130, 200, False, torch.float32, 128),
               (96, 330, True, torch.bfloat16, 128)]


@pytest.mark.parametrize("sq,sk,causal,dtype,d", SPLIT_CASES)
def test_split_pair_matches_jax_split(monkeypatch, sq, sk, causal, dtype, d):
    """Rows 17 and 18 (the port's split pair, plain on the CPU) against
    JAX's _bwd_dkv_kernel and _bwd_dq_kernel, from the same lse and o."""
    _mode(monkeypatch, "split")
    st = jfa.dense_bwd_schedule_stats(2, sq, sk, d, jnp.float32, causal)
    assert st["path"] == "split_resident"
    q, k, v, do = _inputs(2, sq, sk, d, dtype, seed=sq + sk + d)
    scale = d ** -0.5
    qs = fa._prescale(q, scale)
    o, lse, delta = _fwd_stats(qs, k, v, do, causal)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse, delta, causal, scale)
    dq = fa.flash_bwd_dq(qs, k, v, do, lse, delta, causal, scale)
    want = _jax_bwd(_jnp(qs), _jnp(k), _jnp(v), _jnp(o),
                          jnp.asarray(_np(lse)), _jnp(do), causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close(name, _np(g), np.asarray(w.astype(jnp.float32)), dtype)


def test_port_fwd_matches_jax_stream_forward(monkeypatch):
    """Row 13: JAX's K/V-streaming forward (_fwd_kernel_stream), forced by
    STREAM_KV_BYTES = 0, against the port's forward (row 14's function)."""
    monkeypatch.setattr(jfa, "STREAM_KV_BYTES", 0)
    calls = []
    orig = jfa._flash_fwd_stream
    monkeypatch.setattr(jfa, "_flash_fwd_stream",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    for causal, sq, sk in ((True, 384, 384), (False, 128, 300)):
        qs, k, v, _ = _inputs(2, sq, sk, 64, torch.float32, seed=sq)
        qs = qs * (fa.LOG2E / 8.0)
        o_j, lse_j = _jit(jfa._flash_fwd, (3, 4, 5, 6))(
            _jnp(qs), _jnp(k), _jnp(v), causal, None, 128, 128)
        o, lse = fa.flash_fwd(qs, k, v, causal)
        np.testing.assert_allclose(_np(o), np.asarray(o_j), **TOL)
        np.testing.assert_allclose(_np(lse), np.asarray(lse_j), **TOL)
    assert len(calls) == 2


@pytest.mark.parametrize("mode", ["auto", "split"])
def test_port_bwd_matches_jax_dq_partials_backward(monkeypatch, mode):
    """Row 15: JAX's dQ-partials streaming backward (_bwd_fused_stream_call),
    forced by STREAM_KV_BYTES = 0 and _FLAT_BWD_VMEM_BUDGET = 0, against
    the port's backward in either mode (row 16's function, or rows 17 and
    18)."""
    _mode(monkeypatch, mode)
    monkeypatch.setattr(jfa, "STREAM_KV_BYTES", 0)
    monkeypatch.setattr(jfa, "_FLAT_BWD_VMEM_BUDGET", 0)
    assert jfa.dense_bwd_schedule_stats(2, 320, 320, 64, jnp.float32,
                                        True)["path"] == "fused_stream"
    calls = []
    orig = jfa._bwd_fused_stream_call
    monkeypatch.setattr(jfa, "_bwd_fused_stream_call",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    q, k, v, do = _inputs(2, 320, 320, 64, torch.float32, seed=15)
    qs = fa._prescale(q, 0.125)
    o, lse, delta = _fwd_stats(qs, k, v, do, True)
    before = (fa.flash_bwd.launches, fa.flash_bwd_dkv.launches)
    got = fa._bwd_calls(qs, k, v, do, lse, delta, True, 0.125)
    assert (fa.flash_bwd.launches, fa.flash_bwd_dkv.launches) == before
    want = _jax_bwd(_jnp(qs), _jnp(k), _jnp(v), _jnp(o),
                          jnp.asarray(_np(lse)), _jnp(do), True, 0.125)
    assert calls == [1]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# (e) the block entries, (f) a block decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "split"])
@pytest.mark.parametrize("sq,sk,causal", [(256, 256, True),
                                          (256, 128, False)])
def test_block_entries_match_jax(monkeypatch, mode, sq, sk, causal):
    _mode(monkeypatch, mode)
    q, k, v, do = _inputs(2, sq, sk, 64, torch.float32, seed=sq + sk)
    o, lse = fa.flash_block_fwd(q, k, v, causal, 0.125)
    o_j, lse_j = _jit(jfa.flash_block_fwd, (3, 4))(
        _jnp(q), _jnp(k), _jnp(v), causal, 0.125)
    np.testing.assert_allclose(_np(o), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_j), **TOL)
    delta = (do * o).sum(-1)
    got = fa.flash_block_bwd(q, k, v, do, lse, delta, causal, 0.125)
    want = _jit(jfa.flash_block_bwd, (6, 7))(
        _jnp(q), _jnp(k), _jnp(v), _jnp(do), jnp.asarray(_np(lse)),
        jnp.asarray(_np(delta)), causal, 0.125)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **TOL)


def test_block_bwd_refuses_unaligned_lengths():
    q = torch.zeros(1, 200, 16)
    k = torch.zeros(1, 128, 16)
    stats = torch.zeros(1, 200)
    with pytest.raises(ValueError, match="128-aligned"):
        fa.flash_block_bwd(q, k, k, q, stats, stats, True, 0.25)
    with pytest.raises(ValueError, match="128-aligned"):
        jfa.flash_block_bwd(jnp.zeros((1, 200, 16)), jnp.zeros((1, 128, 16)),
                            jnp.zeros((1, 128, 16)), jnp.zeros((1, 200, 16)),
                            jnp.zeros((1, 200)), jnp.zeros((1, 200)), True,
                            0.25)


def _decompose(fwd, bwd, lse_merge, exp, q, k, v, do, nb, scale):
    """Four KV blocks: forwards merged by log-sum-exp, backwards under
    the global lse and delta, dQ summed and dK/dV concatenated; beside
    one full call of each. Non-causal (a ring's off-diagonal blocks)."""
    sk = k.shape[1]
    cut = [slice(j * sk // nb, (j + 1) * sk // nb) for j in range(nb)]
    parts = [fwd(q, k[:, c], v[:, c], False, scale) for c in cut]
    lse = lse_merge([p[1] for p in parts])
    o = sum(p[0] * exp(p[1] - lse)[..., None] for p in parts)
    delta = (do * o).sum(-1)
    grads = [bwd(q, k[:, c], v[:, c], do, lse, delta, False, scale)
             for c in cut]
    dq = sum(g[0] for g in grads)
    dk = np.concatenate([np.asarray(g[1]) for g in grads], axis=1)
    dv = np.concatenate([np.asarray(g[2]) for g in grads], axis=1)
    o_f, lse_f = fwd(q, k, v, False, scale)
    g_f = bwd(q, k, v, do, lse_f, (do * o_f).sum(-1), False, scale)
    return ([np.asarray(x) for x in (o, lse, dq, dk, dv)],
            [np.asarray(x) for x in (o_f, lse_f, *g_f)])


def test_block_decomposition_equals_full_attention(monkeypatch):
    _mode(monkeypatch, "auto")
    q, k, v, do = _inputs(2, 256, 512, 16, torch.float32, seed=6)
    blocks_t, full_t = _decompose(
        fa.flash_block_fwd, fa.flash_block_bwd,
        lambda ls: torch.logsumexp(torch.stack(ls), 0), torch.exp, q, k, v,
        do, 4, 0.25)
    jf, jb = _jit(jfa.flash_block_fwd, (3, 4)), _jit(jfa.flash_block_bwd,
                                                       (6, 7))
    blocks_j, full_j = _decompose(
        jf, jb, lambda ls: jax.nn.logsumexp(jnp.stack(ls), 0), jnp.exp,
        *(_jnp(t) for t in (q, k, v, do)), 4, 0.25)
    names = ("o", "lse", "dq", "dk", "dv")
    for name, a, b, c, d in zip(names, blocks_t, full_t, blocks_j, full_j):
        np.testing.assert_allclose(a, b, err_msg=f"port {name}", **TOL)
        np.testing.assert_allclose(c, d, err_msg=f"jax {name}", **TOL)
        np.testing.assert_allclose(a, c, err_msg=f"port/jax {name}", **TOL)


# ---------------------------------------------------------------------------
# the plain backward's chunks
# ---------------------------------------------------------------------------

def _unchunked_bwd(q, k, v, do, lse, delta, causal, scale):
    """flash_bwd_plain as it was before it chunked: one [Sq, Sk] f32 tile
    per head."""
    sq, sk = q.shape[1], k.shape[1]
    dt = q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf @ kf.transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.arange(sk)[None, :]
                          > torch.arange(sq)[:, None], fa._MASK)
    p = torch.exp2(s - lse.float()[..., None] * fa.LOG2E)
    dv = (p.to(dt).float().transpose(1, 2) @ dof).to(dt)
    dp = dof @ vf.transpose(1, 2)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = ((ds.transpose(1, 2) @ qf) * fa.LN2).to(dt)
    dq = ((ds @ kf) * scale).to(dt)
    return dq, dk, dv


@pytest.mark.parametrize("sq,sk,causal", [(300, 300, True), (130, 200, False),
                                          (200, 130, True)])
def test_chunked_plain_bwd_equals_unchunked(monkeypatch, sq, sk, causal):
    """The plain backward in one chunk and, with its tile shrunk, in query
    chunks of 64 and 37 rows (dK/dV summed over chunks) equals the
    unchunked walk; the split pair's plain versions are its bits."""
    q, k, v, do = _inputs(3, sq, sk, 32, torch.float32, seed=sq)
    qs = fa._prescale(q, 32 ** -0.5)
    _, lse, delta = _fwd_stats(qs, k, v, do, causal)
    want = _unchunked_bwd(qs, k, v, do, lse, delta, causal, 32 ** -0.5)
    for rows in (sq, 64, 37):
        monkeypatch.setattr(fa, "_PLAIN_TILE", rows * sk)
        got = fa.flash_bwd_plain(qs, k, v, do, lse, delta, causal,
                                 32 ** -0.5)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                       msg=f"{name} rows={rows}")
        dk, dv = fa.flash_bwd_dkv_plain(qs, k, v, do, lse, delta, causal,
                                        32 ** -0.5)
        dq = fa.flash_bwd_dq_plain(qs, k, v, do, lse, delta, causal,
                                   32 ** -0.5)
        assert torch.equal(dq, got[0]) and torch.equal(dk, got[1]) \
            and torch.equal(dv, got[2])


# ---------------------------------------------------------------------------
# (g) three train steps under each mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["split", "auto"])
def test_train_steps_match_jax_under_each_mode(monkeypatch, mode):
    """Three tiny fp32 Llama train steps: the port under ``split`` against
    JAX under split (its rows 17 and 18), the port under ``auto`` against
    JAX with its streaming forward forced (row 13, then its fused
    backward). Tolerances of tests/test_torch_train.py."""
    _mode(monkeypatch, mode)
    calls = []
    if mode == "auto":
        monkeypatch.setattr(jfa, "STREAM_KV_BYTES", 0)
        orig = jfa._flash_fwd_stream
        monkeypatch.setattr(jfa, "_flash_fwd_stream",
                            lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    jcfg = jl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         inter=128, seq=256)
    tcfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         inter=128, seq=256)
    params = jax.tree_util.tree_map(np.asarray,
                                    jl.init_llama_params(jcfg, seed=0))
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 96, size=(2, 256)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    step_j, _, _ = jl.build_train_step(
        jcfg, jl.ParallelConfig(use_flash=True, remat=True))
    step_t, _, _ = tl.build_train_step(tcfg, tl.ParallelConfig(remat=True),
                                       device="cpu")
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_j = jl._adamw_init(p_j)
    p_t = tl.params_from_numpy(params, "cpu")
    opt_t = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, opt_j),
                                 "cpu")
    losses_j, losses_t = [], []
    for _ in range(3):
        p_j, opt_j, loss_j = step_j(p_j, opt_j, ids, labels)
        p_t, opt_t, loss_t = step_t(p_t, opt_t, ids, labels)
        losses_j.append(float(loss_j))
        losses_t.append(float(loss_t))
    assert mode == "split" or calls   # JAX's streaming forward ran
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, p_j))
    got = [torch.stack(x) if isinstance(x, list) else x
           for x in _leaves(p_t)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=5e-6)


def _leaves(tree):
    """The port's params in the order of jax.tree_util.tree_leaves (dict
    keys sorted), a per-layer list kept whole."""
    for key in sorted(tree):
        val = tree[key]
        yield from (_leaves(val) if isinstance(val, dict) else [val])
