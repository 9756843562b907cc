"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.rms_norm import fused_rms_norm, rms_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,shape,tol", [
    (torch.float32, (8, 64), dict(rtol=1e-6, atol=1e-6)),
    (torch.float32, (3, 5, 4096), dict(rtol=1e-6, atol=1e-6)),
    # bf16: the two sum in another order, so a result may round one bf16
    # step apart
    (torch.bfloat16, (8, 4096), dict(rtol=2.0 ** -7, atol=1e-5)),
    (torch.bfloat16, (256, 4096), dict(rtol=2.0 ** -7, atol=1e-5)),
])
def test_rms_norm_kernel_matches_plain(dev, dtype, shape, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=dev).to(dtype)
    before = fused_rms_norm.launches
    got = fused_rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert fused_rms_norm.launches == before + 1
    torch.testing.assert_close(got, rms_norm_plain(x, w, 1e-5), **tol)


def _paged_case(dev, nh, nkv, hd, positions, dtype, seed=0, bs=128):
    """Ragged rows over fragmented random tables."""
    rng = np.random.RandomState(seed)
    b, kvd = len(positions), nkv * hd
    need = [p // bs + 1 for p in positions]
    n_pool = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, max(need) + 1), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    q = rng.randn(b, nh, hd) * (pa.LOG2E / hd ** 0.5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    return dict(q=t(q), new_k=t(rng.randn(b, kvd)), new_v=t(rng.randn(b, kvd)),
                k_pool=t(rng.randn(2, n_pool, kvd, bs)),
                v_pool=t(rng.randn(2, n_pool, kvd, bs)),
                tables=torch.from_numpy(tables).to(dev),
                positions=torch.tensor(positions, dtype=torch.int32,
                                       device=dev), layer=1)


@pytest.mark.parametrize("dtype,nh,nkv,hd,atol", [
    (torch.float32, 4, 2, 16, 1e-5),      # llama_tiny geometry
    (torch.float32, 32, 8, 128, 1e-5),    # GQA at head_dim 128
    # bf16 P is rounded before P.V in both; an f32 sum in another order
    # can move a P that sits on a rounding boundary by one bf16 step
    (torch.bfloat16, 32, 32, 128, 2e-3),  # llama_7b (MHA)
])
def test_paged_attend_update_kernel_matches_plain(dev, dtype, nh, nkv, hd,
                                                  atol):
    # 128 and 256 open a fresh block; 0 is a live row of one token
    a = _paged_case(dev, nh, nkv, hd, [0, 5, 127, 128, 256, 700], dtype)
    kp2, vp2 = a["k_pool"].clone(), a["v_pool"].clone()
    before = pa.paged_attend_update.launches
    got = pa.paged_attend_update(a["q"], a["new_k"], a["new_v"], a["k_pool"],
                                 a["v_pool"], a["tables"], a["positions"],
                                 a["layer"])
    ref = pa.paged_attend_update_plain(a["q"], a["new_k"], a["new_v"], kp2,
                                       vp2, a["tables"], a["positions"],
                                       a["layer"])
    torch.cuda.synchronize()
    assert pa.paged_attend_update.launches == before + 1
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    assert torch.equal(a["k_pool"], kp2) and torch.equal(a["v_pool"], vp2)


def test_paged_attend_update_kernel_rejects_bad_inputs(dev):
    a = _paged_case(dev, 4, 2, 16, [3, 9], torch.float32)
    args = [a[k] for k in ("q", "new_k", "new_v", "k_pool", "v_pool",
                           "tables", "positions")]
    with pytest.raises(TypeError):
        pa.paged_attend_update(*args[:6], args[6].long(), 1)
    with pytest.raises(ValueError):
        pa.paged_attend_update(args[0].cpu(), *args[1:], 1)


def test_decode_step_on_card_matches_cpu(dev):
    """One tiny fp32 decode step through the kernels on the card and
    through the plain versions on the CPU."""
    cfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(2)
    shape = (2, 8, 32, 128)
    kp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    vp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    tables = torch.tensor([[3, 5, 0], [0, 0, 0], [7, 0, 0]], dtype=torch.int32)
    positions = torch.tensor([140, 0, 9], dtype=torch.int32)
    ids = torch.tensor([4, 0, 88], dtype=torch.int32)
    out = []
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        logits, k2, v2 = tl.llama_paged_decode_step(
            p, kp.clone().to(d), vp.clone().to(d), tables.to(d),
            positions.to(d), ids.to(d), cfg)
        out.append((logits.cpu(), k2.cpu(), v2.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-4, rtol=0)
    for got, want in zip(out[1][1:], out[0][1:]):
        torch.testing.assert_close(got[:, 1:], want[:, 1:], atol=1e-5, rtol=0)


def _flash_case(dev, dtype, bh, s, d, seed, sk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    sk = s if sk is None else sk
    qs = (torch.randn((bh, s, d), generator=g, device=dev)
          * (fa.LOG2E / d ** 0.5)).to(dtype)
    k = torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((bh, sk, d), generator=g, device=dev).to(dtype)
    do = torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
    return qs, k, v, do


def _close(got, ref, tol):
    """On every element |got - ref| <= rel (|ref| + max |ref| of its row +
    rms(ref)), rows along the last axis, and ||got - ref|| / ||ref|| <=
    frob, for tol = (rel, frob): the kernels sum in another order than the
    plain version, and a bf16 result may round one step apart. The row
    max holds each row to its own scale; the rms floor covers rows that
    are zero but for rounding noise."""
    rel, frob = tol
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    limit = rel * (r.abs() + r.abs().amax(-1, keepdim=True)
                   + r.square().mean().sqrt())
    assert (diff <= limit).all(), \
        f"{(diff - limit).max().item():.3e} over the elementwise limit"
    fro = (diff.norm() / r.norm()).item()
    assert fro <= frob, f"relative Frobenius error {fro:.3e} over {frob}"


# (rel, frob) forward and backward. f32: sums in another order (and dQ by
# atomics). bf16: P and dS are rounded at the same points in both, a
# result can still round one bf16 step apart: rel 2^-6; frob 2^-10 lies
# between a summation order's ~1e-4 and the ~2e-3 of P or dS unrounded.
FLASH_TOL = {torch.float32: ((1e-5, 1e-5), (1e-4, 1e-4)),
             torch.bfloat16: ((2 ** -6, 2 ** -10), (2 ** -6, 2 ** -10))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [77, 200, 256])
def test_flash_kernels_match_plain(dev, dtype, d, causal, s):
    qs, k, v, do = _flash_case(dev, dtype, 6, s, d, seed=s + d)
    tol_f, tol_b = FLASH_TOL[dtype]
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(qs, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = fa.flash_bwd(qs, k, v, do, lse_ref, delta, causal, d ** -0.5)
    want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, delta, causal,
                              d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    _close(o, o_ref, tol_f)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g_).all(), name
        _close(g_, w_, tol_b)


def test_flash_fwd_kv_len_masks_the_tail(dev):
    qs, k, v, _ = _flash_case(dev, torch.bfloat16, 4, 100, 128, seed=9,
                              sk=160)
    o, lse = fa.flash_fwd(qs, k, v, False, kv_len=130)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k[:, :130].contiguous(),
                                        v[:, :130].contiguous(), False)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[torch.bfloat16][0])
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)


def test_flash_attention_autograd_on_card_matches_cpu(dev):
    """The differentiable entry through both kernels on the card against
    the plain versions on the CPU (f32, GQA, causal); each launch
    counted once."""
    rng = np.random.RandomState(3)
    x = [torch.from_numpy(rng.randn(*sh).astype(np.float32))
         for sh in ((2, 150, 4, 64), (2, 150, 2, 64), (2, 150, 2, 64),
                    (2, 150, 4, 64))]
    out = []
    for d in ("cpu", dev):
        q, k, v = (t.to(d).detach().requires_grad_() for t in x[:3])
        before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
        o = fa.flash_attention_bshd(q, k, v, causal=True)
        o.backward(x[3].to(d))
        launched = (fa.flash_fwd.launches - before[0],
                    fa.flash_bwd.launches - before[1])
        out.append([t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)])
        assert launched == ((0, 0) if d == "cpu" else (1, 1))
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_kernels_reject_bad_inputs(dev):
    qs, k, v, _ = _flash_case(dev, torch.bfloat16, 2, 64, 96, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(qs, k, v)
    qs, k, v, _ = _flash_case(dev, torch.bfloat16, 2, 64, 64, seed=0)
    with pytest.raises(TypeError):
        fa.flash_fwd(qs, k.float(), v)
    with pytest.raises(ValueError):
        fa.flash_fwd(qs, k.cpu(), v)


def test_train_steps_on_card_match_cpu(dev):
    """Three tiny fp32 train steps through the kernels on the card and
    through the plain versions on the CPU, from the same weights."""
    cfg = tl.llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                        seq=256)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 96, size=(2, 200)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    res = []
    for d in ("cpu", dev):
        step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(),
                                         device=d)
        params = tl.init_llama_params(cfg, seed=1, device="cpu")
        params = {k: ({kk: vv.to(d) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(d))
                  for k, v in params.items()}
        opt = tl._adamw_init(params)
        before = fa.flash_bwd.launches
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        res.append((losses, params["layers"]["q_proj"].cpu(),
                    fa.flash_bwd.launches - before))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    torch.testing.assert_close(res[1][1], res[0][1], rtol=0, atol=5e-6)
    assert res[0][2] == 0 and res[1][2] == 3 * cfg.num_hidden_layers
