"""Port parity: paddle_tpu_torch/ops/flash_attention.py against
paddle_tpu/ops/flash_attention.py.

The same seeded numpy inputs go through JAX's ``flash_attention_bshd``
under ``jax.vjp`` (Pallas in interpret mode on the CPU, the resident
forward and the fused flat backward) and through the port's autograd entry
on the CPU, which runs each kernel's plain PyTorch version. JAX runs in
both softmax modes: the port implements the online recurrence only, and in
f32 the default fixed-base mode agrees with it to rounding.

Tolerance (f32): 2e-5 absolute and relative on o, lse and the gradients.
Both sides accumulate in f32 in another order (JAX's tiles are 128 or the
whole sequence, the port's 64 keys); the largest difference seen is a few
1e-6.

Tolerance (bf16, S <= 64: one tile and one running max on both sides, so
P and dS are rounded against the same values): elementwise
|got - ref| <= 2^-6 (|ref| + the row's max |ref| + rms(ref)), a few bf16
steps, and ||got - ref|| / ||ref|| <= 2^-10, which a P or dS left
unrounded exceeds (about 2.5e-3) and a summation order does not (about
1e-4). lse (f32): 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import _common
from paddle_tpu.ops import flash_attention as jfa

from paddle_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(params=["online", "auto"])
def softmax_mode(request, monkeypatch):
    monkeypatch.setenv(jfa.ENV_FLASH_SOFTMAX, request.param)
    return request.param


def _inputs(b, s, h, hkv, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, block):
    def f(q, k, v):
        return jfa.flash_attention_bshd(q, k, v, causal=causal,
                                        block_q=block, block_k=block)
    o, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o,) + pull(jnp.asarray(do))]


def _port_vjp(q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention_bshd(qt, kt, vt, causal=causal)
    o.backward(torch.from_numpy(do))
    return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


# (S, Hkv, D, causal, block): S = 300 with 128-blocks gives JAX three
# ragged tiles; the port's 64-key tiles are ragged at 200 and 300
CASES = [
    (128, 4, 16, False, 1024),
    (128, 2, 64, True, 1024),
    (200, 4, 64, True, 1024),
    (200, 2, 16, False, 1024),
    (300, 2, 16, True, 128),
    (300, 4, 64, False, 128),
]


@pytest.mark.parametrize("s,hkv,d,causal,block", CASES)
def test_flash_attention_bshd_matches_jax(softmax_mode, s, hkv, d, causal,
                                          block):
    q, k, v, do = _inputs(2, s, 4, hkv, d, seed=s + d + hkv)
    want = _jax_vjp(q, k, v, do, causal, block)
    got = _port_vjp(q, k, v, do, causal)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _bf16_close(name, got, want, rel=2 ** -6, frob=2 ** -10):
    """The bf16 rule stated at the top; rows are the last axis."""
    g = torch.from_numpy(np.array(got, np.float32))
    r = torch.from_numpy(np.array(want, np.float32))
    diff = (g - r).abs()
    limit = rel * (r.abs() + r.abs().amax(-1, keepdim=True)
                   + r.square().mean().sqrt())
    assert (diff <= limit).all(), \
        f"{name}: {(diff - limit).max().item():.3e} over the limit"
    fro = (diff.norm() / r.norm()).item()
    assert fro <= frob, f"{name}: relative Frobenius error {fro:.3e}"


def _bf16(x):
    """x rounded to bf16, as f32 numpy (exact in both frameworks)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("s,d,causal", [(64, 64, True), (64, 128, False),
                                        (50, 128, True), (50, 64, False)])
def test_flash_attention_bf16_matches_jax(softmax_mode, s, d, causal):
    """bf16 o, lse and gradients against JAX where both see one tile: the
    rounding points of P (forward and dV) and dS (dK, dQ) are compared."""
    q, k, v, do = (_bf16(x) for x in _inputs(2, s, 2, 2, d, seed=s + d))
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))

    def f(q, k, v):
        return jfa.flash_attention_bshd(q, k, v, causal=causal)
    o_j, pull = jax.vjp(f, qj, kj, vj)
    want = [np.asarray(x.astype(jnp.float32)) for x in (o_j,) + pull(doj)]
    scale = d ** -0.5
    qs_j = (qj.astype(jnp.float32) * (scale * jfa._LOG2E)).astype(
        jnp.bfloat16)
    to_bh = lambda x: x.transpose(0, 2, 1, 3).reshape(4, s, d)
    _, lse_j = jfa._flash_fwd(to_bh(qs_j), to_bh(kj), to_bh(vj), causal,
                              None, 1024, 1024)

    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    o_t = fa.flash_attention_bshd(qt, kt, vt, causal=causal)
    o_t.backward(torch.from_numpy(do).to(torch.bfloat16))
    qs_t = (qt.detach().float() * (scale * fa.LOG2E)).to(torch.bfloat16)
    to_bh_t = lambda x: x.transpose(1, 2).reshape(4, s, d).contiguous()
    _, lse_t = fa.flash_fwd(to_bh_t(qs_t), to_bh_t(kt.detach()),
                            to_bh_t(vt.detach()), causal)
    got = [x.detach().float().numpy()
           for x in (o_t, qt.grad, kt.grad, vt.grad)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        _bf16_close(name, g, w)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_lse_matches_jax(softmax_mode, causal):
    """o and the natural-log lse of the pre-scaled [BH, S, D] forward."""
    rng = np.random.RandomState(7)
    qs = (rng.randn(8, 300, 64) * (jfa._LOG2E / 8.0)).astype(np.float32)
    k = rng.randn(8, 300, 64).astype(np.float32)
    v = rng.randn(8, 300, 64).astype(np.float32)
    o_j, lse_j = jfa._flash_fwd(jnp.asarray(qs), jnp.asarray(k),
                                jnp.asarray(v), causal, None, 128, 128)
    o_t, lse_t = fa.flash_fwd(*(torch.from_numpy(x) for x in (qs, k, v)),
                              causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_adversarial_spread_stays_finite_and_matches_online(monkeypatch):
    """A later tile's row max exceeds tile 0's by more than 130 log2
    units: the online recurrence stays finite and equals JAX's online
    mode."""
    monkeypatch.setenv(jfa.ENV_FLASH_SOFTMAX, "online")
    rng = np.random.RandomState(3)
    bh, s, d = 2, 256, 16
    qs = rng.randn(bh, s, d).astype(np.float32) * 0.1
    k = rng.randn(bh, s, d).astype(np.float32) * 0.1
    v = rng.randn(bh, s, d).astype(np.float32)
    # q . k = 200 on keys 200..203 for every query row: far above tile 0
    qs[:, :, 0] = 10.0
    k[:, 200:204, 0] = 20.0
    o_j, lse_j = jfa._flash_fwd(jnp.asarray(qs), jnp.asarray(k),
                                jnp.asarray(v), False, None, 128, 128)
    o_t, lse_t = fa.flash_fwd(*(torch.from_numpy(x) for x in (qs, k, v)))
    s0 = (qs[:, :, None, :] * k[:, None, :128, :]).sum(-1).max()
    s1 = (qs[:, :, None, :] * k[:, None, 128:, :]).sum(-1).max()
    assert s1 - s0 > 130
    assert torch.isfinite(o_t).all() and torch.isfinite(lse_t).all()
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=2e-6)


def test_cpu_tensors_leave_launch_counters_unchanged():
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 70, 2, 2, 16, 0))
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    q.requires_grad_()
    fa.flash_attention_bshd(q, k, v, causal=True).backward(do)
    qs = torch.from_numpy(rng.randn(2, 70, 16).astype(np.float32))
    o, lse = fa.flash_fwd(qs, qs, qs, True)
    fa.flash_bwd(qs, qs, qs, o, lse, (o * o).sum(-1), True, 0.25)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before


def test_plain_bwd_matches_autograd_of_plain_attention():
    """The plain fused backward against autograd through a dense f32
    softmax attention (independent of both frameworks' flash code)."""
    rng = np.random.RandomState(5)
    bh, s, d, scale = 3, 90, 16, 0.25
    q, k, v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                   for _ in range(4))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    sc = (q @ k.transpose(1, 2)) * scale
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -1e30)
    (torch.softmax(sc, dim=-1) @ v).backward(do)
    qs = (q.detach() * (scale * fa.LOG2E))
    o, lse = fa.flash_fwd(qs, k.detach(), v.detach(), True)
    dq, dk, dv = fa.flash_bwd(qs, k.detach(), v.detach(), do, lse,
                              (do * o).sum(-1), True, scale)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(got, want, **TOL)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, kv_len=9)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, q, q, q, torch.zeros(2, 7), torch.zeros(2, 8),
                     False, 0.25)
