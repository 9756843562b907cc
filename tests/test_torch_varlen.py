"""Port parity: packed varlen attention (paddle_tpu_torch/ops/flash_varlen.py
and nn/functional/attention.py) against paddle_tpu.

The same seeded numpy inputs go through JAX's ``flash_varlen_attention``
(Pallas in interpret mode on the CPU, JAX's blocks of 128, jitted) and
through the port's autograd entry on the CPU, which runs each kernel's
plain PyTorch version. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, ``python3 chip_smoke.py``).

Tolerances, each with its reason:
- host planning and the path choice: bitwise (integer functions of cu);
- o and lse in f32: 1e-5 absolute and relative (both sides sum in f32,
  in another order and at other tiles: JAX's 128 keys, the port's 64);
- dq, dk, dv of sum(o^2) in f32: 1e-4 absolute and relative (the same
  sums through five products);
- a row with no live key: dq exactly 0 on both sides;
- nn.functional on the CPU (JAX's padded-batch branch on both sides):
  1e-5.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import _common
from paddle_tpu.ops import flash_varlen as jv

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.ops import flash_varlen as tv

D = 64
SCALE = 1.0 / np.sqrt(D)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_varlen_bwd_parity.py's layouts
LAYOUTS = {
    "single_token": [1] * 9,
    "tile_boundary": [128, 256, 128],
    "pad_tail": [100, 61],
    "empty_segments": [64, 0, 100, 0, 31],
    "mixed": [1, 128, 3, 257, 1],
}
# the main path's packs: bench.py's 16 lengths, and 16 x 4096
SHORT_PACK = [2048, 512, 1024, 3072, 256, 896, 1536, 2048,
              128, 512, 768, 1024, 640, 384, 512, 640]
LONG_PACK = [4096] * 16
PLAN_PACKS = dict(LAYOUTS, short_pack=SHORT_PACK, long_pack=LONG_PACK)


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _rand(rng, t, h):
    return rng.randn(t, h, D).astype(np.float32)


# ---------------------------------------------------------------------------
# host planning and the path choice
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=range(1, 8))
def _jax_planning(cu, n_q, n_k, bq, bk, t, causal, flats):
    """JAX's planning functions, one compile per shape."""
    fj = jv._fwd_bounds(cu, cu, n_q, bq, bk, t, causal, True)
    out = (jv._live_col_tiles(cu, cu, n_q, bq, bk, t) + fj
           + jv._bwd_bounds(cu, cu, n_k, bq, bk, t, causal, True))
    for n_flat in flats:
        out += jv._flat_schedule(*fj, n_q, n_flat)
    return out + (jv._codes_from_cu(cu, t),)


@pytest.mark.parametrize("name", sorted(PLAN_PACKS))
@pytest.mark.parametrize("causal", [False, True])
def test_planning_bitwise(name, causal):
    cu = _cu(PLAN_PACKS[name])
    t = int(cu[-1])
    cj, ct = jnp.asarray(cu), torch.from_numpy(cu)
    for bq, bk in ((128, 128), (512, 256)):
        n_q, n_k = -(-t // bq), -(-t // bk)
        flats = (n_q * n_k, max(1, n_q))
        want = _jax_planning(cj, n_q, n_k, bq, bk, t, causal, flats)
        ft = tv._fwd_bounds(ct, ct, n_q, bq, bk, t, causal, True)
        got = (tv._live_col_tiles(ct, ct, n_q, bq, bk, t) + ft
               + tv._bwd_bounds(ct, ct, n_k, bq, bk, t, causal, True))
        for n_flat in flats:
            got += tv._flat_schedule(*ft, n_q, n_flat)
        got += (tv._codes_from_cu(ct, t),)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for h, d, dt, jdt in ((32, 128, torch.bfloat16, jnp.bfloat16),
                          (4, 64, torch.float32, jnp.float32)):
        it = 2 if dt == torch.bfloat16 else 4
        for blocks in ((1024, 1024), (128, 128)):
            assert jv._host_plan(cu, cu, t, t, h, d, it, causal, True,
                                 *blocks, max(PLAN_PACKS[name])) == \
                tv._host_plan(cu, cu, t, t, h, d, it, causal, True,
                              *blocks, max(PLAN_PACKS[name]))
        assert jv.varlen_schedule_stats(cu, cu, h, d, causal=causal,
                                        dtype=jdt) == \
            tv.varlen_schedule_stats(ct, ct, h, d, causal=causal, dtype=dt)


def _jax_path(lens, h, d, itemsize, block_q=1024, block_k=1024):
    """(stacked, fused) as JAX's eager flash_varlen_attention chooses."""
    cu = _cu(lens)
    t = int(cu[-1])
    plan = jv._host_plan(cu, cu, t, t, h, d, itemsize, True, True,
                         block_q, block_k)
    bq, bk = plan["block_q"], plan["block_k"]
    tp = -(-t // bq) * bq
    return plan["stacked"], jv._bwd_fused_nh(h, itemsize, d, bq, bk, tp) > 0


@pytest.mark.parametrize("name", sorted(PLAN_PACKS))
def test_path_choice_equals_jax(name):
    lens = PLAN_PACKS[name]
    t = sum(lens)
    for h, d, dt in ((32, 128, torch.bfloat16), (8, 128, torch.float32),
                     (4, 64, torch.float32)):
        it = 2 if dt == torch.bfloat16 else 4
        for blocks in ((1024, 1024), (128, 128)):
            assert tv.plan_path(t, t, len(lens), h, d, dt, True, *blocks) \
                == _jax_path(lens, h, d, it, *blocks), (h, d, dt, blocks)


def test_main_path_packs_take_rows_19_21_and_20_22_23():
    # at 32 heads x 128 in bf16: the short pack is stacked (row 19) with
    # the fused backward (row 21); the long pack is row 20 with the split
    # pair (rows 22, 23)
    assert tv.plan_path(16000, 16000, 16, 32, 128, torch.bfloat16, True) \
        == (True, True)
    assert tv.plan_path(65536, 65536, 16, 32, 128, torch.bfloat16, True) \
        == (False, False)


def test_vmem_selector_pins():
    # tests/test_varlen_bwd_parity.py::test_bwd_fused_nh_selection_pins
    for args in ((8, 2, 128, 512, 512, 16384), (8, 2, 128, 1024, 1024, 131072),
                 (8, 4, 32, 128, 128, 1024), (6, 4, 32, 128, 128, 1024),
                 (32, 2, 128, 512, 512, 16384),
                 (32, 2, 128, 1024, 1024, 65536)):
        assert tv._bwd_fused_nh(*args) == jv._bwd_fused_nh(*args), args
    assert tv._bwd_fused_nh(32, 2, 128, 512, 512, 16384) == 4
    assert tv._bwd_fused_nh(32, 2, 128, 1024, 1024, 65536) == 0
    for h in (4, 6, 8, 32):
        for it in (2, 4):
            for bq, bk in ((512, 512), (256, 512)):
                assert tv._stacked_nh(h, it, 128, bq, bk) == \
                    jv._stacked_nh(h, it, 128, bq, bk)
    assert tv._stacked_nh(8, itemsize=2, d=128) == \
        jv._stacked_nh(8, itemsize=2, d=128)


# ---------------------------------------------------------------------------
# forward and gradients against JAX
# ---------------------------------------------------------------------------

def _jax_fwd(q, k, v, cu_q, cu_k, causal, self_attn):
    """JAX's row-20 forward at blocks of 128: (o, lse) [H, T, .]."""
    f = jax.jit(lambda q, k, v, cq, ck: jv._flash_varlen_fwd_impl(
        q, k, v, cq, ck, causal, SCALE, 128, 128, self_attn))
    o, lse = f(*(jnp.asarray(x.transpose(1, 0, 2)) for x in (q, k, v)),
               jnp.asarray(cu_q), jnp.asarray(cu_k))
    return np.asarray(o), np.asarray(lse)


def _jax_grads(q, k, v, cu_q, cu_k, causal, self_attn):
    """o and the grads of sum(o^2) through JAX's flash_varlen_attention."""
    cq, ck = jnp.asarray(cu_q), jnp.asarray(cu_k)
    if self_attn:
        ck = cq

    def loss(q, k, v):
        o = jv.flash_varlen_attention(q, k, v, cq, ck, SCALE, causal,
                                      self_attn=self_attn, block_q=128,
                                      block_k=128)
        return (o ** 2).sum(), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o,) + tuple(g)]


def _port_grads(q, k, v, cu_q, cu_k, causal, self_attn):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    cq = torch.from_numpy(cu_q)
    ck = cq if self_attn else torch.from_numpy(cu_k)
    o = tv.flash_varlen_attention(qt, kt, vt, cq, ck, SCALE, causal)
    (o ** 2).sum().backward()
    return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


def _assert_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL, err_msg="o")
    for g, w, nm in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"d{nm}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fwd_o_and_lse_match_jax(name, causal):
    cu = _cu(LAYOUTS[name])
    rng = np.random.RandomState(sum(map(ord, name)) % 1000)
    q, k, v = (_rand(rng, int(cu[-1]), 2) for _ in range(3))
    o_j, lse_j = _jax_fwd(q, k, v, cu, cu, causal, True)
    o_t, lse_t = tv.varlen_fwd(
        *(torch.from_numpy(x).transpose(0, 1) for x in (q, k, v)),
        torch.from_numpy(cu), torch.from_numpy(cu), causal, SCALE)
    np.testing.assert_allclose(o_t.numpy(), o_j, **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["mixed", "empty_segments", "pad_tail"])
def test_grads_match_jax_fused(name, causal):
    cu = _cu(LAYOUTS[name])
    t = int(cu[-1])
    assert tv.plan_path(t, t, len(cu) - 1, 2, D, torch.float32, True,
                        128, 128)[1]
    rng = np.random.RandomState(7 + len(name))
    q, k, v = (_rand(rng, t, 2) for _ in range(3))
    _assert_grads(_port_grads(q, k, v, cu, cu, causal, True),
                  _jax_grads(q, k, v, cu, cu, causal, True))


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_split(causal, monkeypatch):
    """Both sides forced to the split backward by the VMEM budget knob."""
    cu = _cu([60, 130, 200, 40])
    t = int(cu[-1])
    rng = np.random.RandomState(31)
    q, k, v = (_rand(rng, t, 2) for _ in range(3))
    monkeypatch.setattr(jv, "_FUSED_BWD_VMEM_BUDGET", 0)
    monkeypatch.setattr(tv, "_FUSED_BWD_VMEM_BUDGET", 0)
    calls = []
    for name in ("varlen_bwd", "varlen_bwd_dkv", "varlen_bwd_dq"):
        def spy(*a, _f=getattr(tv, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(tv, name, spy)
    want = _jax_grads(q, k, v, cu, cu, causal, True)
    got = _port_grads(q, k, v, cu, cu, causal, True)
    assert sorted(calls) == ["varlen_bwd_dkv", "varlen_bwd_dq"], calls
    _assert_grads(got, want)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_split_drift_reference_matches_plain(name):
    """chip_smoke's f64 reference for the split backward's drift rule
    (``varlen_bwd_f64``, causal self-attention, bf16) keeps the plain
    versions' rounding points: rounded to bf16 it stands within the
    kernels' bf16 limits of ``varlen_bwd_dq_plain`` and
    ``varlen_bwd_dkv_plain`` (both sum P and dS rounded at the same
    points; only f32 against f64 sums differ)."""
    from chip_smoke import FLASH_TOL, flash_close, varlen_bwd_f64
    lens = LAYOUTS[name]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    t = int(cu[-1])
    rng = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(rng.randn(2, t, D).astype(np.float32))
                   .bfloat16() for _ in range(4))
    o, lse = tv.varlen_fwd_plain(q, k, v, cu, cu, True, SCALE)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, cu, cu, True, SCALE)
    plain = (tv.varlen_bwd_dq_plain(*args), *tv.varlen_bwd_dkv_plain(*args))
    ref = varlen_bwd_f64(q, k, v, do, lse, delta, lens, SCALE, rows=64)
    rel, frob = FLASH_TOL[torch.bfloat16][1]
    for a, b in zip(plain, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float64
        ok, excess, fro, _ = flash_close(a, b.to(torch.bfloat16), rel, frob)
        assert ok, (name, excess, fro)


def test_stacked_row_19_function_is_row_20():
    """A short-segment pack that JAX sends to its stacked forward (row 19,
    ``_flash_varlen_fwd_stacked``) gives the port's row-20 path's o and
    lse within 1e-5: one function at two TPU tilings."""
    lens = [70, 300, 33, 129, 256, 64]
    cu = _cu(lens)
    t, h = int(cu[-1]), 4
    assert jv._host_plan(cu, cu, t, t, h, D, 4, True, True, 1024,
                         1024)["stacked"]
    assert tv.plan_path(t, t, len(lens), h, D, torch.float32, True)[0]
    rng = np.random.RandomState(13)
    q, k, v = (_rand(rng, t, h) for _ in range(3))
    f = jax.jit(lambda q, k, v, cq: jv._flash_varlen_fwd_stacked(
        q, k, v, cq, True, SCALE, jv.STACKED_BLOCK_Q, jv.STACKED_BLOCK_K))
    o_j, lse_j = f(*(jnp.asarray(x.transpose(1, 0, 2)) for x in (q, k, v)),
                   jnp.asarray(cu))
    o_t, lse_t = tv.varlen_fwd(
        *(torch.from_numpy(x).transpose(0, 1) for x in (q, k, v)),
        torch.from_numpy(cu), torch.from_numpy(cu), True, SCALE)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)
    # and through the public entry, grads included
    _assert_grads(_port_grads(q, k, v, cu, cu, True, True),
                  _jax_grads(q, k, v, cu, cu, True, True))


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attn_empty_k_segment_dq_is_exactly_zero(causal):
    lens_q, lens_k = [40, 8, 30], [64, 0, 32]
    cq, ck = _cu(lens_q), _cu(lens_k)
    rng = np.random.RandomState(29)
    q = _rand(rng, int(cq[-1]), 2)
    k, v = (_rand(rng, int(ck[-1]), 2) for _ in range(2))
    got = _port_grads(q, k, v, cq, ck, causal, False)
    want = _jax_grads(q, k, v, cq, ck, causal, False)
    np.testing.assert_array_equal(got[1][40:48], 0.0)
    np.testing.assert_array_equal(want[1][40:48], 0.0)
    np.testing.assert_array_equal(got[0][40:48], 0.0)
    _assert_grads(got, want)


def test_cross_attn_unequal_lengths_causal_is_top_left():
    """len_q != len_k under causal: query position i within its sequence
    sees key positions <= i (not FlashAttention-2's bottom-right)."""
    lens_q, lens_k = [50, 20, 90], [30, 70, 90]
    cq, ck = _cu(lens_q), _cu(lens_k)
    rng = np.random.RandomState(5)
    q = _rand(rng, int(cq[-1]), 2)
    k, v = (_rand(rng, int(ck[-1]), 2) for _ in range(2))
    got = _port_grads(q, k, v, cq, ck, True, False)
    _assert_grads(got, _jax_grads(q, k, v, cq, ck, True, False))
    # row 0 of each sequence sees exactly its sequence's key 0
    for s in range(3):
        np.testing.assert_allclose(got[0][cq[s]], v[ck[s]], **FWD_TOL)


def test_gqa_matches_jax():
    cu = _cu([70, 58, 1, 100])
    t = int(cu[-1])
    rng = np.random.RandomState(3)
    q = _rand(rng, t, 4)
    k, v = (_rand(rng, t, 2) for _ in range(2))
    _assert_grads(_port_grads(q, k, v, cu, cu, True, True),
                  _jax_grads(q, k, v, cu, cu, True, True))


def test_max_seqlen_smaller_than_longest_segment_raises():
    cu = torch.tensor([0, 300, 400], dtype=torch.int32)
    q = torch.randn(400, 2, D)
    with pytest.raises(ValueError, match="max_seqlen"):
        tv.flash_varlen_attention(q, q, q, cu, cu, scale=0.125, causal=True,
                                  max_seqlen=256)
    # the longest segment itself is accepted
    tv.flash_varlen_attention(q, q, q, cu, cu, scale=0.125, causal=True,
                              max_seqlen=300)


def test_layout_forms_and_the_cuda_contract():
    """The wrappers read [H, T, D] either contiguous or as the view of a
    packed [T, H, D]; any other stride is no form, and a CPU tensor never
    passes the kernels' contract check."""
    x = torch.randn(8, 2, 3, D)[:, :, 0]     # strided, neither form
    assert tv._packed(x.transpose(0, 1)) is None
    assert tv._packed(torch.randn(2, 8, D)) == 0
    assert tv._packed(torch.randn(8, 2, D).transpose(0, 1)) == 1
    cu = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tv._check_cuda("varlen_fwd", x.transpose(0, 1), (), (), (cu,))


# ---------------------------------------------------------------------------
# nn.functional on the CPU (JAX's padded-batch branch on both sides)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attn_unpadded_cpu_matches_jax(causal, hkv):
    lens = [5, 1, 9, 3, 0, 12]
    cu = _cu(lens)
    t = int(cu[-1])
    rng = np.random.RandomState(11)
    q = _rand(rng, t, 4)
    k, v = (_rand(rng, t, hkv) for _ in range(2))
    cut = paddle.to_tensor(cu)
    want, _ = JF.flash_attn_unpadded(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v), cut,
        cut, max_seqlen_q=max(lens), max_seqlen_k=max(lens), causal=causal)
    cuq = torch.from_numpy(cu)
    got, sm = TF.flash_attn_unpadded(
        *(torch.from_numpy(x) for x in (q, k, v)), cuq, cuq,
        max_seqlen_q=max(lens), max_seqlen_k=max(lens), causal=causal)
    assert sm is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_flash_attn_unpadded_cpu_cross_lengths_and_scale():
    lens_q, lens_k = [4, 7, 2], [6, 3, 8]
    cq, ck = _cu(lens_q), _cu(lens_k)
    rng = np.random.RandomState(12)
    q = _rand(rng, int(cq[-1]), 2)
    k, v = (_rand(rng, int(ck[-1]), 2) for _ in range(2))
    want, _ = JF.flash_attn_unpadded(
        *(paddle.to_tensor(x) for x in (q, k, v)), paddle.to_tensor(cq),
        paddle.to_tensor(ck), max_seqlen_q=7, max_seqlen_k=8, scale=0.3,
        causal=True)
    got, _ = TF.flash_attn_unpadded(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(cq),
        torch.from_numpy(ck), max_seqlen_q=7, max_seqlen_k=8, scale=0.3,
        causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


@pytest.mark.parametrize("mask", [None, "bool", "float"])
@pytest.mark.parametrize("causal", [False, True])
def test_scaled_dot_product_attention_cpu_matches_jax(mask, causal):
    rng = np.random.RandomState(21)
    b, s, h, hkv = 2, 9, 4, 2
    q = rng.randn(b, s, h, D).astype(np.float32)
    k, v = (rng.randn(b, s, hkv, D).astype(np.float32) for _ in range(2))
    m = None
    if mask == "bool":
        m = rng.rand(b, 1, s, s) > 0.3
    elif mask == "float":
        m = rng.randn(b, 1, s, s).astype(np.float32)
    jm = None if m is None else paddle.to_tensor(m)
    tm = None if m is None else torch.from_numpy(m)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), attn_mask=jm,
        is_causal=causal)
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=tm,
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)
    out, sm = TF.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal)
    assert sm is None and out.shape == (b, s, h, D)


def test_flash_attn_unpadded_cpu_backward_no_cross_sequence_leak():
    lens = [6, 5]
    cu = torch.from_numpy(_cu(lens))
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(_rand(rng, 11, 2)).requires_grad_()
               for _ in range(3))
    out, _ = TF.flash_attn_unpadded(q, k, v, cu, cu, 6, 6, causal=True)
    (out[:6] ** 2).sum().backward()
    assert torch.isfinite(q.grad).all()
    assert (k.grad[6:] == 0).all() and (v.grad[6:] == 0).all()
