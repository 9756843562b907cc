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
from paddle_tpu_torch.ops import flash_varlen as fv
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
    # ernie_moe_fine's hidden width: blocks of another width
    (torch.bfloat16, (8 * 512, 1024), dict(rtol=2.0 ** -7, atol=1e-5)),
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


RMS_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
           torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


def _rms_held(dev, dtype, n, h, eps, zero_row=False):
    """Row 1 against its plain version at [n, h]: RMS_TOL, the output
    memory poisoned with NaN first, bf16 also within 2^-12 rel frob (one
    rounding after x * inv * w in f32, as chip_smoke's
    RMS_SCHEDULE_FROB), the same bits from a second call, a row of zeros
    exactly 0."""
    g = torch.Generator(device=dev).manual_seed(n + h)
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    if zero_row:
        x[n // 2] = 0
    w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
    outs = []
    for _ in range(2):
        keep = torch.full((n, h), float("nan"), device=dev, dtype=dtype)
        del keep
        outs.append(fused_rms_norm(x, w, eps))
    ref = rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], ref, **RMS_TOL[dtype])
    if dtype == torch.bfloat16:
        fro = (outs[0].float() - ref.float()).norm() / ref.float().norm()
        assert fro <= 2 ** -12, fro
    assert torch.equal(outs[0], outs[1])
    if zero_row:
        assert bool((outs[0][n // 2] == 0).all())


@pytest.mark.parametrize("h", [1024, 2048, 4096, 5120])
@pytest.mark.parametrize("n", [1, 8, 256, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_grid(dev, dtype, n, h):
    """Every row count and width the port runs: a decode step's 1 and 8
    rows, a prefill chunk, a train step; ERNIE, TinyLlama, Llama and
    llama_13b widths."""
    _rms_held(dev, dtype, n, h, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_odd_eps_and_zero_row(dev, dtype):
    _rms_held(dev, dtype, 256, 4096, 0.37)
    _rms_held(dev, dtype, 8, 5120, 1e-6, zero_row=True)


def test_rms_norm_kernel_refuses_rows_over_its_registers(dev):
    x = torch.ones((2, 32768 + 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte vectors a row"):
        fused_rms_norm(x, torch.ones(x.shape[1], device=dev,
                                     dtype=torch.bfloat16))
    y = torch.ones((2, 32768), device=dev, dtype=torch.bfloat16)
    assert fused_rms_norm(y, torch.ones(32768, device=dev,
                                        dtype=torch.bfloat16)).shape == y.shape


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


@pytest.mark.parametrize("dtype,nh,nkv,hd,atol", [
    (torch.float32, 4, 2, 16, 1e-5),
    (torch.float32, 32, 8, 128, 1e-5),
    (torch.bfloat16, 32, 32, 128, 2e-3),  # row 3's shape (llama_7b)
])
def test_paged_attention_kernel_matches_plain(dev, dtype, nh, nkv, hd,
                                              atol):
    """Row 2, read-only: lengths 0 (output exactly 0), 1, a block edge
    and a fresh block over fragmented tables; the pools are untouched."""
    a = _paged_case(dev, nh, nkv, hd, [0, 5, 127, 128, 256, 700], dtype)
    lengths = torch.tensor([0, 1, 128, 129, 256, 700], dtype=torch.int32,
                           device=dev)
    kp2, vp2 = a["k_pool"].clone(), a["v_pool"].clone()
    before = pa.paged_attention.launches
    got = pa.paged_attention(a["q"], a["k_pool"], a["v_pool"], a["tables"],
                             lengths, a["layer"])
    ref = pa.paged_attention_plain(a["q"], kp2, vp2, a["tables"], lengths,
                                   a["layer"])
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(a["k_pool"], kp2) and torch.equal(a["v_pool"], vp2)


# Rows 3 and 2 split each row's blocks across CTAs (kernel_splits); the
# plain version at that split is the same computation. Lengths on and
# next to block edges, 0 and 1, and a row across every block of the table;
# two padding rows (null table, position 0) that write and read block 0.
SPLIT_NB = 6


def _paged_split_case(dev, dtype, rep, hd, bs, seed, spread=None):
    rng = np.random.RandomState(seed)
    nkv = 2
    lengths = [1, bs - 1, bs, bs + 1, 2 * bs, 3 * bs + 1, SPLIT_NB * bs,
               0, 0]
    b, kvd = len(lengths), nkv * hd
    need = [-(-n // bs) for n in lengths]
    n_pool = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, SPLIT_NB), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    k_pool = rng.randn(2, n_pool, kvd, bs)
    if spread is not None:     # the long row's last three blocks lead
        k_pool[:, tables[6, 3:]] *= spread
    q = rng.randn(b, nkv * rep, hd) * (pa.LOG2E / hd ** 0.5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=t(q), new_k=t(rng.randn(b, kvd)), new_v=t(rng.randn(b, kvd)),
                k_pool=t(k_pool), v_pool=t(rng.randn(2, n_pool, kvd, bs)),
                tables=torch.from_numpy(tables).to(dev), lengths=lengths,
                positions=torch.clamp(lengths - 1, min=0), layer=1)


def _check_paged_split(dev, dtype, rep, hd, bs, seed, spread=None,
                       f32_atol=1e-5):
    a = _paged_split_case(dev, dtype, rep, hd, bs, seed, spread)
    atol = f32_atol if dtype == torch.float32 else 2e-3
    splits = pa.kernel_splits(SPLIT_NB, bs)
    live = a["lengths"] > 0
    # row 2
    ro = [pa.paged_attention(a["q"], a["k_pool"], a["v_pool"], a["tables"],
                             a["lengths"], a["layer"]) for _ in range(2)]
    ref = pa.paged_attention_plain(a["q"], a["k_pool"], a["v_pool"],
                                   a["tables"], a["lengths"], a["layer"],
                                   splits=splits)
    # row 3
    kp, vp = a["k_pool"].clone(), a["v_pool"].clone()
    call = (a["q"], a["new_k"], a["new_v"], a["k_pool"], a["v_pool"],
            a["tables"], a["positions"], a["layer"])
    up = [pa.paged_attend_update(*call) for _ in range(2)]
    ref_up = pa.paged_attend_update_plain(a["q"], a["new_k"], a["new_v"],
                                          kp, vp, a["tables"],
                                          a["positions"], a["layer"],
                                          splits=splits)
    torch.cuda.synchronize()
    # the padding rows race on block 0, so only live rows keep their bits
    assert torch.equal(ro[0], ro[1]) and torch.equal(up[0][live], up[1][live])
    torch.testing.assert_close(ro[0], ref, atol=atol, rtol=0)
    assert not ro[0][~live].any()
    torch.testing.assert_close(up[0][live], ref_up[live], atol=atol, rtol=0)
    # block 0 is the null block the padding rows scribble on
    assert torch.equal(a["k_pool"][:, 1:], kp[:, 1:])
    assert torch.equal(a["v_pool"][:, 1:], vp[:, 1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_paged_split_kernels_match_plain(dev, dtype, bs, hd, rep):
    """Rows 3 and 2 against their plain versions at the kernel's split,
    the same bits over two calls, the pools as the plain version leaves
    them."""
    _check_paged_split(dev, dtype, rep, hd, bs, seed=rep + hd + bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,bs", [(1, 512), (2, 512), (1, 1024),
                                    (2, 1024)])
def test_paged_split_kernels_at_large_blocks(dev, dtype, rep, bs):
    """Blocks of 512 and 1024 tokens (the kernel's 1024-thread form),
    where a block's K or V slice takes more pieces than the ring holds."""
    _check_paged_split(dev, dtype, rep, 128, bs, seed=rep + bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_kernels_hold_a_score_spread(dev, dtype):
    """The long row's last three blocks lead its first three by hundreds
    of log2 units, across split boundaries. Its scores reach about 400,
    where one f32 ulp of a score moves P by about 2e-5 relative: the f32
    case takes atol 1e-4."""
    a = _paged_split_case(dev, torch.float32, 2, 64, 128, 9, spread=150.0)
    kt = a["k_pool"][1, a["tables"][6].long()].reshape(SPLIT_NB, 2, 64, 128)
    s = torch.einsum("grd,jgdt->jgrt", a["q"][6].reshape(2, 2, 64), kt)
    assert (s[3:].amax() - s[:3].amax()).item() > 200
    _check_paged_split(dev, dtype, 2, 64, 128, 9, spread=150.0,
                       f32_atol=1e-4)


def test_paged_split_sync_words_come_back_to_zero(dev):
    """Every launch of rows 3 and 2 leaves its stream's sync words zero."""
    from paddle_tpu_torch.ops import decode_attention as da
    _check_paged_split(dev, torch.bfloat16, 1, 128, 128, 1)
    stream = torch.cuda.current_stream(dev)
    assert not da._SYNC[(dev if dev.index is not None
                         else torch.device("cuda", 0),
                         stream.cuda_stream)].any()


def test_paged_attention_kernel_rejects_bad_inputs(dev):
    a = _paged_case(dev, 4, 2, 16, [3, 9], torch.float32)
    lengths = a["positions"] + 1
    args = [a[k] for k in ("q", "k_pool", "v_pool", "tables")]
    with pytest.raises(TypeError):
        pa.paged_attention(*args, lengths.long(), 1)
    with pytest.raises(TypeError):
        pa.paged_attention(args[0].bfloat16(), *args[1:], lengths, 1)
    with pytest.raises(ValueError):
        pa.paged_attention(args[0].cpu(), *args[1:], lengths, 1)
    with pytest.raises(ValueError):
        pa.paged_attention(*args, lengths, 2)                # layer >= L


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


def _verify_case(dev, dtype, nh, nkv, hd, qstart, T, seed=0, bs=128,
                 spread=None):
    """Rows with qstart cached tokens over fragmented random tables that
    also hold the T fed positions; qstart 0 is a padding row (null
    table). ``spread`` scales every row's second block of keys, so its
    scores lead the first block's by hundreds of log2 units; then q lies
    on a 2^-5 grid and the keys on a 2^-4 grid (integers in the scaled
    block), so f32 holds every score exactly in any summation order (at
    |s| ~ 800 two orders differ by ~1e-4, which near-tied keys turn into
    output errors over the f32 limit)."""
    rng = np.random.RandomState(seed)
    b, kvd = len(qstart), nkv * hd
    need = [-(-(q + T) // bs) if q else 0 for q in qstart]
    n_pool = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, max(need) + 1), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    k_pool = rng.randn(2, n_pool, kvd, bs)
    q = rng.randn(b, T, nh, hd) * (pa.LOG2E / hd ** 0.5)
    if spread is not None:
        k_pool = np.round(k_pool * 16) / 16
        for i, n in enumerate(need):
            if n > 1:
                k_pool[1, tables[i, 1]] = np.round(k_pool[1, tables[i, 1]]
                                                   * spread)
        q = np.round(q * 32) / 32
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    return dict(q=t(q), k_pool=t(k_pool),
                v_pool=t(rng.randn(2, n_pool, kvd, bs)),
                tables=torch.from_numpy(tables).to(dev),
                qstart=torch.tensor(qstart, dtype=torch.int32, device=dev),
                new_k=t(rng.randn(2, b, T, kvd)),
                new_v=t(rng.randn(2, b, T, kvd)))


VERIFY_QSTART = [0, 1, 127, 128, 129, 700]   # 0: padding; 128 fills a block


@pytest.mark.parametrize("dtype,nh,nkv,hd,T,spread", [
    (torch.float32, 4, 2, 16, 4, None),     # llama_tiny geometry
    (torch.float32, 8, 4, 32, 1, 150.0),    # REP 2
    (torch.float32, 16, 4, 64, 3, 150.0),   # REP 4
    (torch.float32, 32, 4, 128, 8, 150.0),  # REP 8, T 8: 64 rows, 8 chunks
    (torch.bfloat16, 32, 32, 128, 5, None),  # llama_7b, draft_k 4
    (torch.bfloat16, 32, 8, 128, 7, None),
])
def test_paged_verify_kernel_matches_plain(dev, dtype, nh, nkv, hd, T,
                                           spread):
    """Row 6 against its plain version at the kernel's split (rows of up
    to 6 blocks over 7-block tables: 7 splits): the finalised acc / l
    under the flash rule, m + log2(l) to 1e-4 + 1e-6 |ref| (f32: a few
    steps at the spread's |lse| of about 800) or 1e-3 + 1e-5 |ref| (bf16:
    scores summed in another order), a padding row's defined partials
    exactly and the same bits on a second call."""
    a = _verify_case(dev, dtype, nh, nkv, hd, VERIFY_QSTART, T,
                     spread=spread)
    args = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"], 1)
    splits = pa.kernel_splits(a["tables"].shape[1], 128)
    assert splits > 1
    before = pa.paged_attention_verify.launches
    acc, m, l = pa.paged_attention_verify(*args)
    again = pa.paged_attention_verify(*args)
    ra, rm, rl = pa.paged_attention_verify_plain(*args, splits=splits)
    torch.cuda.synchronize()
    assert pa.paged_attention_verify.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((acc, m, l), again))
    live = a["qstart"] > 0
    _close(acc[live] / l[live][..., None], ra[live] / rl[live][..., None],
           FLASH_TOL[dtype][0])
    torch.testing.assert_close(
        m[live] + torch.log2(l[live]), rm[live] + torch.log2(rl[live]),
        **(dict(rtol=1e-6, atol=1e-4) if dtype == torch.float32
           else dict(rtol=1e-5, atol=1e-3)))
    assert torch.equal(acc[~live], torch.zeros_like(acc[~live]))
    assert torch.equal(l[~live], torch.zeros_like(l[~live]))
    assert torch.equal(m[~live], torch.full_like(m[~live], -1e30))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs,nh,T", [(256, 16, 5), (512, 16, 5),
                                     (1024, 8, 2)])
def test_paged_verify_kernels_at_large_blocks(dev, kind, bs, nh, T):
    """Rows 6 and 7 over blocks of 256 to 1024 tokens (512 and 1024: the
    kernel's 1024-thread form), GQA over 4 kv-heads of 64 (20 query rows a
    kv-head in 3 chunks of 8; at bs 1024, where 8 rows' partial scores of
    bf16 or int8 outgrow shared memory, 4 rows in one chunk), qstart across
    block edges: the flash rule (f32 forward entry over f32 and int8
    pools, bf16's over bf16 pools) at the kernel's split and a padding
    row's partials exactly."""
    qstart = [0, 1, bs - 1, bs + 3, 2 * bs + 5]
    if kind == "int8":
        a = _quant_case(dev, torch.bfloat16, nh, 4, 64, qstart, T=T, bs=bs)
        args = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"],
                a["v_scale"], a["tables"], a["rows"], a["layer"])
        kern, plain = (pa.paged_attention_verify_quant,
                       pa.paged_attention_verify_quant_plain)
        live, tol = a["rows"] > 0, FLASH_TOL[torch.float32][0]
    else:
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        a = _verify_case(dev, dtype, nh, 4, 64, qstart, T, bs=bs)
        args = (a["q"], a["k_pool"], a["v_pool"], a["tables"], a["qstart"],
                1)
        kern, plain = pa.paged_attention_verify, pa.paged_attention_verify_plain
        live, tol = a["qstart"] > 0, FLASH_TOL[dtype][0]
    acc, m, l = kern(*args)
    ra, rm, rl = plain(*args, splits=pa.kernel_splits(a["tables"].shape[1],
                                                      bs))
    torch.cuda.synchronize()
    _close(acc[live] / l[live][..., None], ra[live] / rl[live][..., None],
           tol)
    assert torch.equal(acc[~live], torch.zeros_like(acc[~live]))
    assert torch.equal(m[~live], torch.full_like(m[~live], -1e30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_commit_kernel_matches_plain(dev, dtype):
    """Row 8 against its plain version, bitwise on every block but the
    null block 0: commit lengths 0 to T, windows across a block edge."""
    qstart = [0, 3, 125, 126, 300, 128]
    a = _verify_case(dev, dtype, 8, 4, 32, qstart, 5, seed=4)
    clen = torch.tensor([0, 5, 3, 5, 1, 4], dtype=torch.int32, device=dev)
    kp, vp = a["k_pool"].clone(), a["v_pool"].clone()
    kp2, vp2 = a["k_pool"].clone(), a["v_pool"].clone()
    before = pa.paged_verify_commit.launches
    pa.paged_verify_commit(a["new_k"], a["new_v"], kp, vp, a["tables"],
                           a["qstart"], clen)
    pa.paged_verify_commit_plain(a["new_k"], a["new_v"], kp2, vp2,
                                 a["tables"], a["qstart"], clen)
    torch.cuda.synchronize()
    assert pa.paged_verify_commit.launches == before + 1
    assert torch.equal(kp[:, 1:], kp2[:, 1:])
    assert torch.equal(vp[:, 1:], vp2[:, 1:])
    assert not torch.equal(kp[:, 1:], a["k_pool"][:, 1:])
    # an accepted column landed: row 2's third token at position 127
    assert torch.equal(kp[1, a["tables"][2, 0], :, 127], a["new_k"][1, 2, 2])


def test_verify_and_commit_kernels_reject_bad_inputs(dev):
    a = _verify_case(dev, torch.float32, 4, 2, 16, [3, 9], 4)
    with pytest.raises(ValueError, match="fed tokens"):
        pa.paged_attention_verify(a["q"].repeat(1, 3, 1, 1).contiguous(),
                                  a["k_pool"], a["v_pool"], a["tables"],
                                  a["qstart"], 1)
    with pytest.raises(TypeError):
        pa.paged_attention_verify(a["q"], a["k_pool"], a["v_pool"],
                                  a["tables"], a["qstart"].long(), 1)
    with pytest.raises(ValueError, match="device"):
        pa.paged_verify_commit(a["new_k"].cpu(), a["new_v"], a["k_pool"],
                               a["v_pool"], a["tables"], a["qstart"],
                               a["qstart"])
    with pytest.raises(TypeError):
        pa.paged_verify_commit(a["new_k"].double(), a["new_v"].double(),
                               a["k_pool"], a["v_pool"], a["tables"],
                               a["qstart"], a["qstart"])


def test_verify_step_on_card_matches_cpu(dev):
    """One tiny fp32 verify step through rows 6 and 8 on the card and
    through their plain versions on the CPU: tokens, commit lengths and
    the finite screen equal, the pools equal but for block 0."""
    cfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(5)
    shape = (2, 8, 32, 128)
    kp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    vp = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    tables = torch.tensor([[3, 5, 0], [0, 0, 0], [7, 0, 0]], dtype=torch.int32)
    qstart = torch.tensor([126, 0, 9], dtype=torch.int32)
    t_live = torch.tensor([5, 0, 2], dtype=torch.int32)
    fed = torch.from_numpy(rng.randint(1, 96, size=(3, 5)).astype(np.int32))
    out = []
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        before = (pa.paged_attention_verify.launches,
                  pa.paged_verify_commit.launches)
        res = tl.llama_paged_verify_step(
            p, kp.clone().to(d), vp.clone().to(d), tables.to(d),
            qstart.to(d), t_live.to(d), fed.to(d), cfg)
        after = (pa.paged_attention_verify.launches,
                 pa.paged_verify_commit.launches)
        out.append([r.cpu() for r in res])
        if d != "cpu":
            assert after == (before[0] + 2, before[1] + 1)
    for got, want in zip(out[1][:3], out[0][:3]):
        assert torch.equal(got, want)
    for got, want in zip(out[1][3:], out[0][3:]):
        torch.testing.assert_close(got[:, 1:], want[:, 1:], atol=1e-5,
                                   rtol=0)


def _quant_case(dev, qdtype, nh, nkv, hd, counts, T=None, seed=0, bs=128,
                spread=None, layers=2):
    """Int8 pools [layers, NP, KVD, bs] with f32 scale pools over
    fragmented random tables that hold each row's new token at position
    ``counts`` or, with T, its ``counts`` cached tokens and T fed
    positions; q [B, NH, HD] or, with T,
    [B, T, NH, HD]; the T fed columns' codes and scales. Codes are random
    in [-127, 127] and scales powers of two (2^-7 to 2^-5), q lies on a
    2^-5 grid: every score is a sum that f32 holds exactly in any order.
    ``spread`` multiplies the K scales of each row's second block in the
    last layer, so its scores lead the first block's by hundreds of log2
    units."""
    rng = np.random.RandomState(seed)
    b, kvd = len(counts), nkv * hd
    if T is None:           # decode rows: the new token at position c
        need = [c // bs + 1 for c in counts]
    else:                   # verify rows: c cached and T fed (0: padding)
        need = [-(-(c + T) // bs) if c else 0 for c in counts]
    n_pool = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, max(need) + 1), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    codes = lambda *sh: torch.from_numpy(
        rng.randint(-127, 128, size=sh).astype(np.int8)).to(dev)
    scales = lambda *sh: torch.from_numpy(
        (2.0 ** -rng.randint(5, 8, size=sh)).astype(np.float32)).to(dev)
    k_scale = scales(layers, n_pool, nkv, bs)
    if spread is not None:
        for i, n in enumerate(need):
            if n > 1:
                k_scale[-1, int(tables[i, 1])] *= spread
    qshape = (b, nh, hd) if T is None else (b, T, nh, hd)
    q = np.round(rng.randn(*qshape) * (pa.LOG2E / hd ** 0.5) * 32) / 32
    cshape = (layers, b, T or 1)
    return dict(q=torch.from_numpy(q.astype(np.float32)).to(dev, qdtype),
                k_pool=codes(layers, n_pool, kvd, bs),
                v_pool=codes(layers, n_pool, kvd, bs),
                k_scale=k_scale, v_scale=scales(layers, n_pool, nkv, bs),
                tables=torch.from_numpy(tables).to(dev),
                rows=torch.tensor(counts, dtype=torch.int32, device=dev),
                new_k=codes(*cshape, kvd), new_v=codes(*cshape, kvd),
                new_ks=scales(*cshape, nkv), new_vs=scales(*cshape, nkv),
                layer=layers - 1)


QUANT_CASES = [
    (torch.float32, 4, 2, 16, None),        # llama_tiny geometry
    (torch.float32, 8, 4, 32, 128.0),       # REP 2
    (torch.float32, 16, 4, 64, 128.0),      # REP 4
    (torch.float32, 32, 4, 128, 128.0),     # REP 8
    (torch.bfloat16, 32, 32, 128, None),    # llama_7b (MHA)
]


@pytest.mark.parametrize("qdtype,nh,nkv,hd,spread", QUANT_CASES)
def test_paged_quant_kernels_match_plain(dev, qdtype, nh, nkv, hd, spread):
    """Rows 5 and 4 against their plain versions at the kernel's split
    (each split from its own max: P is never rounded). P is f32 in both
    and q is cast to f32 in both, so the flash rule's f32 forward entry
    holds whatever q's dtype; row 5's pools (the written bytes and scales
    included) bitwise; row 4's length-0 row exactly 0."""
    positions = [0, 5, 127, 128, 256, 700]  # 128, 256 open a fresh block
    a = _quant_case(dev, qdtype, nh, nkv, hd, positions, spread=spread)
    pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
    ref_pools = [t.clone() for t in pools]
    new = [a[k][-1, :, 0].contiguous() for k in ("new_k", "new_v", "new_ks",
                                                   "new_vs")]
    splits = pa.kernel_splits(a["tables"].shape[1], 128)
    assert splits > 1
    before = pa.paged_attend_update_quant.launches
    got = pa.paged_attend_update_quant(a["q"], *new, *pools, a["tables"],
                                       a["rows"], a["layer"])
    ref = pa.paged_attend_update_quant_plain(a["q"], *new, *ref_pools,
                                             a["tables"], a["rows"],
                                             a["layer"], splits=splits)
    torch.cuda.synchronize()
    assert pa.paged_attend_update_quant.launches == before + 1
    _close(got, ref, FLASH_TOL[torch.float32][0])
    for g, r in zip(pools, ref_pools):
        assert torch.equal(g, r)
    lengths = torch.tensor([0, 6, 128, 129, 257, 701], dtype=torch.int32,
                           device=dev)
    before = pa.paged_attention_quant.launches
    got = pa.paged_attention_quant(a["q"], *pools, a["tables"], lengths,
                                   a["layer"])
    ref = pa.paged_attention_quant_plain(a["q"], *pools, a["tables"],
                                         lengths, a["layer"], splits=splits)
    torch.cuda.synchronize()
    assert pa.paged_attention_quant.launches == before + 1
    _close(got[1:], ref[1:], FLASH_TOL[torch.float32][0])
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def _quant_split_case(dev, qdtype, rep, hd, bs, seed):
    """int8 pools for rows 5 and 4 over SPLIT_NB-block tables: lengths on
    and next to block edges, 0 and 1, a row across every block of the
    table (rows of 2-4 blocks among them), and two padding rows (null
    table, position 0) that write and read block 0. Codes, power-of-two
    scales and q on a 2^-5 grid as in :func:`_quant_case`."""
    rng = np.random.RandomState(seed)
    nkv = 2
    lengths = [1, bs - 1, bs, bs + 1, 2 * bs, 3 * bs + 1, SPLIT_NB * bs,
               0, 0]
    b, kvd = len(lengths), nkv * hd
    need = [-(-n // bs) for n in lengths]
    n_pool = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, SPLIT_NB), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    codes = lambda *sh: torch.from_numpy(
        rng.randint(-127, 128, size=sh).astype(np.int8)).to(dev)
    scales = lambda *sh: torch.from_numpy(
        (2.0 ** -rng.randint(5, 8, size=sh)).astype(np.float32)).to(dev)
    q = np.round(rng.randn(b, nkv * rep, hd) * (pa.LOG2E / hd ** 0.5) * 32) / 32
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=torch.from_numpy(q.astype(np.float32)).to(dev, qdtype),
                pools=[codes(2, n_pool, kvd, bs), codes(2, n_pool, kvd, bs),
                       scales(2, n_pool, nkv, bs), scales(2, n_pool, nkv, bs)],
                new=[codes(b, kvd), codes(b, kvd), scales(b, nkv),
                     scales(b, nkv)],
                tables=torch.from_numpy(tables).to(dev), lengths=lengths,
                positions=torch.clamp(lengths - 1, min=0), layer=1)


def _check_quant_split(dev, qdtype, rep, hd, bs, seed):
    """Rows 5 and 4 at the kernel's split: the flash rule's f32 forward
    entry against the plain versions, the same bits over two launches (row
    5: its live rows; the padding rows race on block 0), a length-0 row
    exactly 0 over a NaN-poisoned output, the pools bitwise the plain
    version's but block 0, one launch counted a call, and the sync words
    zero after the launches."""
    from paddle_tpu_torch.ops import decode_attention as da
    a = _quant_split_case(dev, qdtype, rep, hd, bs, seed)
    splits = pa.kernel_splits(SPLIT_NB, bs)
    live = a["lengths"] > 0
    tol = FLASH_TOL[torch.float32][0]
    rd = (a["q"], *a["pools"], a["tables"], a["lengths"], a["layer"])
    before = pa.paged_attention_quant.launches
    ro = []
    for _ in range(2):
        torch.full((len(live), a["q"].shape[1], hd), float("nan"), device=dev)
        ro.append(pa.paged_attention_quant(*rd))
    assert pa.paged_attention_quant.launches == before + 2
    ref = pa.paged_attention_quant_plain(*rd, splits=splits)
    ref_pools = [t.clone() for t in a["pools"]]
    call = (a["q"], *a["new"], *a["pools"], a["tables"], a["positions"],
            a["layer"])
    before = pa.paged_attend_update_quant.launches
    up = [pa.paged_attend_update_quant(*call) for _ in range(2)]
    assert pa.paged_attend_update_quant.launches == before + 2
    ref_up = pa.paged_attend_update_quant_plain(
        a["q"], *a["new"], *ref_pools, a["tables"], a["positions"],
        a["layer"], splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(ro[0], ro[1])
    assert torch.equal(up[0][live], up[1][live])
    _close(ro[0][live], ref[live], tol)
    assert torch.equal(ro[0][~live], torch.zeros_like(ro[0][~live]))
    _close(up[0][live], ref_up[live], tol)
    for g, r in zip(a["pools"], ref_pools):
        assert torch.equal(g[:, 1:], r[:, 1:])
    pos = a["positions"][live].long()
    blk = a["tables"][live][torch.arange(len(pos), device=dev), pos // bs]
    assert torch.equal(a["pools"][0][1, blk.long(), :, pos % bs],
                       a["new"][0][live])
    assert torch.equal(a["pools"][2][1, blk.long(), :, pos % bs],
                       a["new"][2][live])
    stream = torch.cuda.current_stream(dev)
    assert not da._SYNC[(dev if dev.index is not None
                         else torch.device("cuda", 0),
                         stream.cuda_stream)].any()


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_paged_quant_split_kernels_match_plain(dev, qdtype, bs, rep):
    """Rows 5 and 4 on the split walk: rows of 1 to SPLIT_NB blocks, REP
    1-8, f32 and bf16 q (see :func:`_check_quant_split`)."""
    _check_quant_split(dev, qdtype, rep, 128, bs, seed=rep + bs)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,bs", [(1, 512), (4, 512), (1, 1024),
                                    (2, 1024)])
def test_paged_quant_split_kernels_at_large_blocks(dev, qdtype, rep, bs):
    """Rows 5 and 4 over blocks of 512 and 1024 tokens (the kernel's
    1024-thread form) at head_dim 64."""
    _check_quant_split(dev, qdtype, rep, 64, bs, seed=rep + bs)


@pytest.mark.parametrize("qdtype,nh,nkv,hd,spread,T", [
    c + (t,) for c, t in zip(QUANT_CASES, (4, 1, 3, 8, 5))])
def test_paged_verify_quant_kernel_matches_plain(dev, qdtype, nh, nkv, hd,
                                                 spread, T):
    """Row 7 against its plain version at the kernel's split (rows of up
    to 6 blocks over 7-block tables): the finalised acc / l under the flash
    rule's f32 forward entry (P f32 in both), m + log2(l) to 1e-4 + 1e-6
    |ref|, a padding row's defined partials exactly and the same bits on a
    second call."""
    a = _quant_case(dev, qdtype, nh, nkv, hd, VERIFY_QSTART, T=T,
                    spread=spread)
    args = (a["q"], a["k_pool"], a["v_pool"], a["k_scale"], a["v_scale"],
            a["tables"], a["rows"], a["layer"])
    splits = pa.kernel_splits(a["tables"].shape[1], 128)
    assert splits > 1
    before = pa.paged_attention_verify_quant.launches
    acc, m, l = pa.paged_attention_verify_quant(*args)
    again = pa.paged_attention_verify_quant(*args)
    ra, rm, rl = pa.paged_attention_verify_quant_plain(*args, splits=splits)
    torch.cuda.synchronize()
    assert pa.paged_attention_verify_quant.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((acc, m, l), again))
    live = a["rows"] > 0
    _close(acc[live] / l[live][..., None], ra[live] / rl[live][..., None],
           FLASH_TOL[torch.float32][0])
    torch.testing.assert_close(m[live] + torch.log2(l[live]),
                               rm[live] + torch.log2(rl[live]), rtol=1e-6,
                               atol=1e-4)
    assert torch.equal(acc[~live], torch.zeros_like(acc[~live]))
    assert torch.equal(l[~live], torch.zeros_like(l[~live]))
    assert torch.equal(m[~live], torch.full_like(m[~live], -1e30))


@pytest.mark.parametrize("nkv,hd", [(2, 16), (4, 32), (32, 128)])
def test_paged_commit_quant_kernel_matches_plain(dev, nkv, hd):
    """Row 9 against its plain version, bitwise on every block but the
    null block 0, for the bytes and the scales: commit lengths 0 to T,
    windows across a block edge, heads narrower than a 128-byte slice."""
    qstart = [0, 3, 125, 126, 300, 128]
    a = _quant_case(dev, torch.float32, nkv, nkv, hd, qstart, T=5, seed=4)
    clen = torch.tensor([0, 5, 3, 5, 1, 4], dtype=torch.int32, device=dev)
    new = [a[k] for k in ("new_k", "new_v", "new_ks", "new_vs")]
    pools = [a[k].clone() for k in ("k_pool", "v_pool", "k_scale",
                                    "v_scale")]
    ref = [t.clone() for t in pools]
    before = pa.paged_verify_commit_quant.launches
    pa.paged_verify_commit_quant(*new, *pools, a["tables"], a["rows"], clen)
    pa.paged_verify_commit_quant_plain(*new, *ref, a["tables"], a["rows"],
                                       clen)
    torch.cuda.synchronize()
    assert pa.paged_verify_commit_quant.launches == before + 1
    for g, r in zip(pools, ref):
        assert torch.equal(g[:, 1:], r[:, 1:])
    assert not torch.equal(pools[2][:, 1:], a["k_scale"][:, 1:])
    # an accepted column landed: row 2's third token at position 127
    blk = a["tables"][2, 0]
    assert torch.equal(pools[0][1, blk, :, 127], a["new_k"][1, 2, 2])
    assert torch.equal(pools[2][1, blk, :, 127], a["new_ks"][1, 2, 2])


# Rows 8 and 9 over commit lengths all 0, all 1, all T and mixed, windows
# across a block edge (qstart bs - 3, bs - 2), block sizes 16 to 1024, in
# f32, bf16 and int8: bitwise the plain version on every block but 0,
# block 0 byte for byte as it was (the kernels write live columns only,
# never block 0), the same bits from a second call, and every live column
# of a real block written. Row 0 is a padding row (qstart 0, a null table).
COMMIT_LENS = {"none": [0] * 6, "one": [1] * 6, "all": [5] * 6,
               "mixed": [0, 5, 3, 5, 1, 4]}


def _commit_qstart(bs):
    return [0, 3, bs - 3, bs - 2, 300, bs]


@pytest.mark.parametrize("lens", list(COMMIT_LENS))
@pytest.mark.parametrize("bs", [16, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
def test_commit_kernels_write_live_columns_only(dev, dtype, bs, lens):
    qstart, clen_l = _commit_qstart(bs), COMMIT_LENS[lens]
    if dtype == "int8":
        a = _quant_case(dev, torch.float32, 4, 4, 32, qstart, T=5, seed=bs,
                        bs=bs)
        new = [a[k] for k in ("new_k", "new_v", "new_ks", "new_vs")]
        orig = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        qs = a["rows"]
        kern, plain = (pa.paged_verify_commit_quant,
                       pa.paged_verify_commit_quant_plain)
    else:
        a = _verify_case(dev, dtype, 4, 4, 32, qstart, 5, seed=bs, bs=bs)
        new, orig = [a["new_k"], a["new_v"]], [a["k_pool"], a["v_pool"]]
        qs = a["qstart"]
        kern, plain = pa.paged_verify_commit, pa.paged_verify_commit_plain
    clen = torch.tensor(clen_l, dtype=torch.int32, device=dev)
    runs = []
    before = kern.launches
    for _ in range(2):
        pools = [t.clone() for t in orig]
        kern(*new, *pools, a["tables"], qs, clen)
        runs.append(pools)
    ref = [t.clone() for t in orig]
    plain(*new, *ref, a["tables"], qs, clen)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    for got, r, o, again in zip(runs[0], ref, orig, runs[1]):
        assert torch.equal(got[:, 1:], r[:, 1:])
        assert torch.equal(got[:, 0], o[:, 0])
        assert torch.equal(got, again)
    written = int((runs[0][0][:, 1:] != orig[0][:, 1:]).any(dim=2).sum())
    assert written == 2 * sum(c for c, q in zip(clen_l, qstart) if q > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"])
def test_commit_kernels_take_odd_widths_and_small_blocks(dev, dtype):
    """KVD = 20 (no whole warp item of 16 rows at its end) and blocks of 4
    tokens under T = 8 (a window across three blocks): bitwise the plain
    version but block 0, block 0 untouched."""
    qstart, T = [0, 3, 6, 9], 8
    clen = torch.tensor([8, 8, 5, 1], dtype=torch.int32, device=dev)
    if dtype == "int8":
        a = _quant_case(dev, torch.float32, 2, 2, 10, qstart, T=T, bs=4)
        new = [a[k] for k in ("new_k", "new_v", "new_ks", "new_vs")]
        orig = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
        qs = a["rows"]
        kern, plain = (pa.paged_verify_commit_quant,
                       pa.paged_verify_commit_quant_plain)
    else:
        a = _verify_case(dev, dtype, 2, 2, 10, qstart, T, bs=4)
        new, orig = [a["new_k"], a["new_v"]], [a["k_pool"], a["v_pool"]]
        qs = a["qstart"]
        kern, plain = pa.paged_verify_commit, pa.paged_verify_commit_plain
    got = [t.clone() for t in orig]
    ref = [t.clone() for t in orig]
    kern(*new, *got, a["tables"], qs, clen)
    plain(*new, *ref, a["tables"], qs, clen)
    torch.cuda.synchronize()
    for g, r, o in zip(got, ref, orig):
        assert torch.equal(g[:, 1:], r[:, 1:])
        assert torch.equal(g[:, 0], o[:, 0])


def test_quant_kernels_reject_bad_inputs(dev):
    a = _quant_case(dev, torch.float32, 4, 2, 16, [3, 9])
    pools = [a[k] for k in ("k_pool", "v_pool", "k_scale", "v_scale")]
    new = [a[k][-1, :, 0].contiguous() for k in ("new_k", "new_v", "new_ks",
                                                   "new_vs")]
    args = (a["tables"], a["rows"], a["layer"])
    with pytest.raises(ValueError, match="device"):
        pa.paged_attention_quant(a["q"].cpu(), *pools, *args)
    with pytest.raises(TypeError, match="int8"):
        pa.paged_attend_update_quant(a["q"], *new, pools[0].float(),
                                     *pools[1:], *args)
    with pytest.raises(TypeError, match="float32"):
        pa.paged_attend_update_quant(a["q"], *new[:2], new[2].double(),
                                     new[3], *pools, *args)
    with pytest.raises(TypeError, match="q must be"):
        pa.paged_attention_quant(a["q"].half(), *pools, *args)
    with pytest.raises(ValueError, match="fed tokens"):
        pa.paged_attention_verify_quant(
            a["q"][:, None].repeat(1, 9, 1, 1).contiguous(), *pools, *args)
    with pytest.raises(TypeError):
        pa.paged_verify_commit_quant(a["new_k"], a["new_v"], a["new_ks"],
                                     a["new_vs"], *pools, a["tables"],
                                     a["rows"].long(), a["rows"])


def test_int8_verify_step_on_card_matches_cpu(dev):
    """One tiny fp32 int8 verify step through rows 7 and 9 on the card and
    through their plain versions on the CPU: tokens, commit lengths and
    the finite screen equal; the pools but block 0 within one code and
    f32 rounding of the scales (the fed columns come from matmuls summed
    in another order on the two devices)."""
    cfg = tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(5)
    shape, sshape = (2, 8, 32, 128), (2, 8, 2, 128)
    pools = [torch.from_numpy(rng.randint(-127, 128, size=shape)
                              .astype(np.int8)) for _ in range(2)]
    pools += [torch.from_numpy((rng.rand(*sshape) * 0.05 + 0.01)
                               .astype(np.float32)) for _ in range(2)]
    tables = torch.tensor([[3, 5, 0], [0, 0, 0], [7, 0, 0]], dtype=torch.int32)
    qstart = torch.tensor([126, 0, 9], dtype=torch.int32)
    t_live = torch.tensor([5, 0, 2], dtype=torch.int32)
    fed = torch.from_numpy(rng.randint(1, 96, size=(3, 5)).astype(np.int32))
    out = []
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        before = (pa.paged_attention_verify_quant.launches,
                  pa.paged_verify_commit_quant.launches)
        kp, vp, ks, vs = (t.clone().to(d) for t in pools)
        res = tl.llama_paged_verify_step(
            p, kp, vp, tables.to(d), qstart.to(d), t_live.to(d), fed.to(d),
            cfg, kv_scales=(ks, vs))
        after = (pa.paged_attention_verify_quant.launches,
                 pa.paged_verify_commit_quant.launches)
        out.append([r.cpu() for r in res])
        if d != "cpu":
            assert after == (before[0] + 2, before[1] + 1)
    for got, want in zip(out[1][:3], out[0][:3]):
        assert torch.equal(got, want)
    for got, want in zip(out[1][3:5], out[0][3:5]):
        assert (got[:, 1:].int() - want[:, 1:].int()).abs().max() <= 1
    for got, want in zip(out[1][5:], out[0][5:]):
        torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-5,
                                   atol=0)


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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [200, 2048])
def test_flash_bwd_wgmma_matches_plain(dev, d, causal, s):
    """Row 16 in bf16 (the wgmma kernel: 128 keys a CTA, dQ by bulk
    reduce-add) at a ragged S and at the train phase's S, 8 heads, against
    its plain version under the flash rule; row 17's dK and dV are its
    bits."""
    qs, k, v, do = _flash_case(dev, torch.bfloat16, 8, s, d, seed=s + d + 1)
    o, lse = fa.flash_fwd_plain(qs, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    before = fa.flash_bwd.launches
    got = fa.flash_bwd(qs, k, v, do, lse, delta, causal, d ** -0.5)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse, delta, causal, d ** -0.5)
    want = fa.flash_bwd_plain(qs, k, v, do, lse, delta, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_bwd.launches == before + 1
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        _close(g_, w_, FLASH_TOL[torch.bfloat16][1])
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


# (Sq, Sk, causal, kv_len): a ragged S, the train phase's S, Sq != Sk
# (flash_block_fwd's shapes, causal top-left) and kv_len < Sk
WG_FWD_LAYOUTS = [(200, 200, True, None), (200, 200, False, None),
                  (2048, 2048, True, None), (256, 512, True, None),
                  (512, 256, True, None), (384, 640, False, None),
                  (300, 1152, True, 1000), (200, 333, False, 130)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", range(len(WG_FWD_LAYOUTS)))
def test_flash_fwd_wgmma_matches_plain(dev, d, layout):
    """Row 14 in bf16 (the wgmma kernel: 128 q rows a CTA, 128-key
    stages by TMA, softmax per 64-key half) against its plain version
    under the flash rule; one launch each."""
    sq, sk, causal, kv_len = WG_FWD_LAYOUTS[layout]
    qs, k, v, _ = _flash_case(dev, torch.bfloat16, 8, sq, d,
                              seed=sq + sk + d, sk=sk)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(qs, k, v, causal, kv_len)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v, causal, kv_len)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert torch.isfinite(o).all()
    _close(o, o_ref, FLASH_TOL[torch.bfloat16][0])
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_wgmma_runs_give_the_same_bits(dev, d):
    """Two runs give the same bits."""
    qs, k, v, _ = _flash_case(dev, torch.bfloat16, 16, 1000, d, seed=d)
    runs = [fa.flash_fwd(qs, k, v, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[1][0], runs[0][0])
    assert torch.equal(runs[1][1], runs[0][1])


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


# (Sq, Sk, causal): a 64-multiple, ragged tails, Sq != Sk both ways under
# causal (top-left), and a ring off-diagonal block (non-causal, Sq != Sk)
SPLIT_LAYOUTS = [(256, 256, True), (200, 200, True), (77, 77, False),
                 (128, 320, False), (320, 128, False), (130, 200, True),
                 (200, 130, True)]


def _split_case(dev, dtype, bh, sq, sk, d, causal, seed, spread=None):
    """Inputs, the forward's lse and delta for the split pair; ``spread``
    scales keys 64..67 so their scores lead the rest by hundreds of log2
    units."""
    qs, k, v, do = _flash_case(dev, dtype, bh, sq, d, seed, sk=sk)
    if spread is not None:
        k[:, 64:68] = (k[:, 64:68].float() * spread).to(dtype)
    o, lse = fa.flash_fwd_plain(qs, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    return qs, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", range(len(SPLIT_LAYOUTS)))
def test_flash_split_kernels_match_plain(dev, dtype, d, layout):
    """Rows 17 and 18 against their plain versions, each launch counted."""
    sq, sk, causal = SPLIT_LAYOUTS[layout]
    args = _split_case(dev, dtype, 6, sq, sk, d, causal, seed=sq + sk + d)
    before = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(*args, causal, d ** -0.5)
    dq = fa.flash_bwd_dq(*args, causal, d ** -0.5)
    dk_r, dv_r = fa.flash_bwd_dkv_plain(*args, causal, d ** -0.5)
    dq_r = fa.flash_bwd_dq_plain(*args, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert torch.isfinite(got).all()
        _close(got, want, FLASH_TOL[dtype][1])


def test_flash_split_kernels_hold_a_score_spread(dev):
    """f32, scores of keys 64..67 hundreds of log2 units over the rest."""
    for sq, sk, causal in ((200, 200, True), (128, 320, False)):
        args = _split_case(dev, torch.float32, 4, sq, sk, 64, causal, seed=5,
                           spread=60.0)
        s = args[0] @ args[1].transpose(1, 2)
        assert s[:, :, 64:68].amax() - s[:, :, :64].amax() > 200
        dk, dv = fa.flash_bwd_dkv(*args, causal, 0.125)
        dq = fa.flash_bwd_dq(*args, causal, 0.125)
        want = fa.flash_bwd_plain(*args, causal, 0.125)
        torch.cuda.synchronize()
        for got, ref in zip((dq, dk, dv), want):
            assert torch.isfinite(got).all()
            _close(got, ref, FLASH_TOL[torch.float32][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(2048, 2048, True),
                                          (200, 200, True),
                                          (128, 320, False)])
def test_flash_split_dkv_is_fused_bits_and_dq_is_deterministic(dev, dtype, sq,
                                                               sk, causal):
    """Row 17's dK and dV are bitwise row 16's on the same inputs (its
    kernel with the dQ product compiled out); row 18's dQ has the same
    bits over two runs (no atomics)."""
    args = _split_case(dev, dtype, 8, sq, sk, 128, causal, seed=11)
    _, dk_f, dv_f = fa.flash_bwd(*args, causal, 128 ** -0.5)
    dk, dv = fa.flash_bwd_dkv(*args, causal, 128 ** -0.5)
    dq1 = fa.flash_bwd_dq(*args, causal, 128 ** -0.5)
    dq2 = fa.flash_bwd_dq(*args, causal, 128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk_f) and torch.equal(dv, dv_f)
    assert torch.equal(dq1, dq2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(200, 330, True), (330, 200, False),
                                          (130, 200, True), (384, 130, True),
                                          (96, 700, False)])
def test_flash_split_dq_wgmma_at_uneven_lengths(dev, d, sq, sk, causal):
    """Row 18 in bf16 (wgmma, 128-key stages) at Sq != Sk with kv tails off
    the stages, causal top-left and not: the flash rule against the plain
    version, the same bits over two runs."""
    args = _split_case(dev, torch.bfloat16, 6, sq, sk, d, causal,
                       seed=sq + 3 * sk + d)
    dq1 = fa.flash_bwd_dq(*args, causal, d ** -0.5)
    dq2 = fa.flash_bwd_dq(*args, causal, d ** -0.5)
    want = fa.flash_bwd_dq_plain(*args, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(dq1).all() and torch.equal(dq1, dq2)
    _close(dq1, want, FLASH_TOL[torch.bfloat16][1])


@pytest.mark.parametrize("mode", ["auto", "split"])
def test_flash_block_entries_on_card_match_cpu(dev, monkeypatch, mode):
    """Four 128-aligned KV blocks: block forwards merged by log-sum-exp
    equal one full-attention forward, and the block backwards under the
    global lse and delta, summed, equal its gradients; card against CPU,
    and against the full call on the card. A key block no q row reaches
    (causal, the last block for the first q rows) gets dK = dV = 0."""
    monkeypatch.setenv(fa.ENV_FLASH_BWD, mode)
    rng = np.random.RandomState(4)
    bh, s, d, nb = 4, 512, 64, 4
    q, k, v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                   for _ in range(4))
    out = []
    for where in ("cpu", dev):
        qd, kd, vd, dod = (t.to(where) for t in (q, k, v, do))
        ob, lb = [], []
        for j in range(nb):
            sl = slice(j * s // nb, (j + 1) * s // nb)
            # the diagonal block is causal; blocks above it are dead
            o_j, l_j = fa.flash_block_fwd(qd, kd[:, sl].contiguous(),
                                          vd[:, sl].contiguous(), False,
                                          d ** -0.5)
            ob.append(o_j)
            lb.append(l_j)
        lse = torch.logsumexp(torch.stack(lb), dim=0)
        o = sum(o_j * torch.exp(l_j - lse)[..., None]
                for o_j, l_j in zip(ob, lb))
        delta = (dod * o).sum(-1)
        grads = [fa.flash_block_bwd(qd, kd[:, j * s // nb:(j + 1) * s // nb]
                                    .contiguous(),
                                    vd[:, j * s // nb:(j + 1) * s // nb]
                                    .contiguous(), dod, lse, delta, False,
                                    d ** -0.5) for j in range(nb)]
        dq = sum(g[0] for g in grads)
        dk = torch.cat([g[1] for g in grads], dim=1)
        dv = torch.cat([g[2] for g in grads], dim=1)
        full = fa.flash_block_fwd(qd, kd, vd, False, d ** -0.5)
        full_g = fa.flash_block_bwd(qd, kd, vd, dod, full[1],
                                    (dod * full[0]).sum(-1), False,
                                    d ** -0.5)
        out.append([t.cpu() for t in (o, lse, dq, dk, dv, *full, *full_g)])
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    o, lse, dq, dk, dv, fo, flse, fdq, fdk, fdv = out[1]
    for got, want in ((o, fo), (lse, flse), (dq, fdq), (dk, fdk), (dv, fdv)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # causal at Sq < Sk masks top-left: keys 128..255 of a 128-row block
    # are reached by no q row, so their dK and dV are exactly 0
    qd, kd, vd, dod = (t.to(dev) for t in (q, k, v, do))
    o, lse = fa.flash_block_fwd(qd, kd, vd, True, d ** -0.5)
    g = fa.flash_block_bwd(qd[:, :128].contiguous(),
                           kd[:, :256].contiguous(), vd[:, :256].contiguous(),
                           dod[:, :128].contiguous(),
                           lse[:, :128].contiguous(),
                           (dod * o).sum(-1)[:, :128].contiguous(), True,
                           d ** -0.5)
    torch.cuda.synchronize()
    assert not g[1][:, 128:].any() and not g[2][:, 128:].any()
    assert g[1][:, :128].any() and g[2][:, :128].any()
    with pytest.raises(ValueError, match="128-aligned"):
        fa.flash_block_bwd(qd[:, :100], kd, vd, dod[:, :100], lse[:, :100],
                           lse[:, :100], True, 0.125)


def test_split_train_steps_on_card_match_cpu(dev, monkeypatch):
    """Three tiny fp32 train steps under PADDLE_TPU_TORCH_FLASH_BWD=split:
    the card (rows 17 and 18, no row 16) against the CPU's plain versions."""
    monkeypatch.setenv(fa.ENV_FLASH_BWD, "split")
    cfg = tl.llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                        seq=256)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 96, size=(2, 200)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    res = []
    for d in ("cpu", dev):
        step, _, _ = tl.build_train_step(cfg, tl.ParallelConfig(), device=d)
        params = tl.init_llama_params(cfg, seed=1, device="cpu")
        params = {k: ({kk: vv.to(d) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(d))
                  for k, v in params.items()}
        opt = tl._adamw_init(params)
        before = (fa.flash_bwd.launches, fa.flash_bwd_dkv.launches,
                  fa.flash_bwd_dq.launches)
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        after = (fa.flash_bwd.launches, fa.flash_bwd_dkv.launches,
                 fa.flash_bwd_dq.launches)
        res.append((losses, params["layers"]["q_proj"].cpu(),
                    tuple(a - b for a, b in zip(after, before))))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    torch.testing.assert_close(res[1][1], res[0][1], rtol=0, atol=5e-6)
    L = cfg.num_hidden_layers
    assert res[0][2] == (0, 0, 0) and res[1][2] == (0, 3 * L, 3 * L)


@pytest.mark.parametrize("s,path", [(16384, "fwd stream"),
                                    (131072, "bwd fused_stream")])
def test_flash_kernels_cover_the_long_paths(dev, s, path):
    """Rows 13 and 15: at the lengths where JAX streams K/V in the forward
    (S = 16384) and hands the backward to its dQ-partials pass (S =
    131072), rows 14 and 16 (and the split pair) against the plain
    versions on every element, at one head (bench.py runs 8 and 4)."""
    st = fa.dense_bwd_schedule_stats(8, s, s, 128, torch.bfloat16, True)
    assert st["fwd_path"] == "stream"
    assert path != "bwd fused_stream" or st["path"] == "fused_stream"
    qs, k, v, do = _flash_case(dev, torch.bfloat16, 1, s, 128, seed=s)
    o, lse = fa.flash_fwd(qs, k, v, True)
    o_r, lse_r = fa.flash_fwd_plain(qs, k, v, True)
    delta = (do.float() * o_r.float()).sum(-1)
    got = fa.flash_bwd(qs, k, v, do, lse_r, delta, True, 128 ** -0.5)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse_r, delta, True, 128 ** -0.5)
    dq = fa.flash_bwd_dq(qs, k, v, do, lse_r, delta, True, 128 ** -0.5)
    want = fa.flash_bwd_plain(qs, k, v, do, lse_r, delta, True, 128 ** -0.5)
    torch.cuda.synchronize()
    tol_f, tol_b = FLASH_TOL[torch.bfloat16]
    _close(o, o_r, tol_f)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=1e-4)
    for a, b in zip(got + (dq, dk, dv), want + want):
        _close(a, b, tol_b)


# ---------------------------------------------------------------------------
# grouped matmul (dropless MoE)
# ---------------------------------------------------------------------------

from paddle_tpu_torch.models import ernie_moe as tm        # noqa: E402
from paddle_tpu_torch.ops import grouped_matmul as tg      # noqa: E402
from paddle_tpu_torch.parallel import moe as tmoe          # noqa: E402

# (rel, frob) of _close. f32: sums in another order. bf16: both sum in
# f32 and round once, so a result may land one bf16 step apart.
GMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -10)}
GMM_LAYOUTS = [[0, 130, 0, 250], [600, 0, 0, 0], [5, 127, 129, 1],
               [128, 256, 128, 128], [0, 90, 1, 0, 300, 3, 0, 77]]


def _gmm_case(dev, dtype, counts, k, n, seed=0, tail_tiles=2):
    counts = torch.tensor(counts, dtype=torch.int32)
    m = int(tg._round_up(counts, 128).sum()) + tail_tiles * 128
    sched = tuple(s.to(dev) for s in
                  tg.tile_schedule(counts, m // 128, 128)[:2])
    g = torch.Generator(device=dev).manual_seed(seed)
    e = len(counts)
    lhs = torch.randn((m, k), generator=g, device=dev).to(dtype)
    rhs = (torch.randn((e, k, n), generator=g, device=dev)
           / k ** 0.5).to(dtype)
    dout = torch.randn((m, n), generator=g, device=dev).to(dtype)
    return counts, m, sched, lhs, rhs, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kn", [(128, 64), (256, 192), (256, 256)])
@pytest.mark.parametrize("counts", GMM_LAYOUTS)
def test_gmm_kernels_match_plain(dev, dtype, kn, counts):
    k, n = kn
    counts, m, sched, lhs, rhs, dout = _gmm_case(dev, dtype, counts, k, n)
    e = len(counts)
    live = int(tg._round_up(counts, 128).sum())
    before = (tg.gmm_fwd.launches, tg.gmm_dx.launches, tg.gmm_dw.launches)
    got = (tg.gmm_fwd(lhs, rhs, sched), tg.gmm_dx(dout, rhs, sched),
           tg.gmm_dw(lhs, dout, sched, num_experts=e))
    want = (tg.gmm_fwd_plain(lhs, rhs, sched),
            tg.gmm_dx_plain(dout, rhs, sched),
            tg.gmm_dw_plain(lhs, dout, sched, num_experts=e))
    torch.cuda.synchronize()
    assert (tg.gmm_fwd.launches, tg.gmm_dx.launches, tg.gmm_dw.launches) \
        == tuple(b + 1 for b in before)
    for name, a, b in zip(("fwd", "dx", "dw"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        _close(a, b, GMM_TOL[dtype])
    # dead tail tiles exactly zero; no tile, exactly zero dW
    assert (got[0][live:] == 0).all() and (got[1][live:] == 0).all()
    for x in range(e):
        if counts[x] == 0:
            assert (got[2][x] == 0).all(), x


@pytest.mark.parametrize("kn", [(256, 192), (1024, 512), (512, 1024)])
def test_gmm_dw_wgmma_runs_give_the_same_bits(dev, kn):
    """bf16 dW (the wgmma kernel) twice on one input: the same bits, each
    expert's tiles summed in tile order with no atomics."""
    k, n = kn
    counts, m, sched, lhs, _, dout = _gmm_case(
        dev, torch.bfloat16, [300, 0, 1000, 129, 0, 640], k, n, seed=k + n)
    a, b = (tg.gmm_dw(lhs, dout, sched, num_experts=6) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (a[1] == 0).all() and (a[4] == 0).all()


@pytest.mark.parametrize("kn", [(256, 192), (1024, 512), (512, 1024)])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_gmm_fwd_dx_wgmma_runs_give_the_same_bits(dev, kind, kn):
    """bf16 forward and dX (the wgmma kernels) twice on one input: the
    same bits, dead tail tiles exactly zero."""
    k, n = kn
    counts, m, sched, lhs, rhs, dout = _gmm_case(
        dev, torch.bfloat16, [300, 0, 1000, 129, 0, 640], k, n, seed=k + n)
    a, b = ((tg.gmm_fwd(lhs, rhs, sched) if kind == "fwd"
             else tg.gmm_dx(dout, rhs, sched)) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (a[int(tg._round_up(counts, 128).sum()):] == 0).all()


# one source's chunk of the ragged all-to-all at ernie_moe_fine's ep-2
# shape: 2048 tokens a rank, top-4, 16 local experts
CHUNK_T, CHUNK_K, CHUNK_E = 2048, 4, 16


def _chunk_counts(kind):
    rows = CHUNK_T * CHUNK_K
    if kind == "spread":
        return np.random.RandomState(3).multinomial(
            rows // 2, [1 / CHUNK_E] * CHUNK_E)
    if kind == "all_to_one":    # every pair of the source on one expert
        return np.array([0, rows] + [0] * (CHUNK_E - 2))
    return np.zeros(CHUNK_E, np.int64)     # the source sends no row


@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024)])
@pytest.mark.parametrize("kind", ["spread", "all_to_one", "empty"])
def test_gmm_kernels_take_a_chunk_schedule(dev, kn, kind):
    """Rows 24-26 in bf16 under ``chunk_schedule``'s schedule of one chunk
    of the ragged all-to-all (chunk_rows = ragged_buffer_rows of the
    shape, the tiles past the chunk's groups dead): against their plain
    versions under GMM_TOL, dead tiles exactly zero, an expert with no
    row exactly zero dW."""
    k, n = kn
    chunk = tmoe.ragged_buffer_rows(CHUNK_T, CHUNK_K, CHUNK_E, 128)
    counts = torch.tensor(_chunk_counts(kind), dtype=torch.int32)
    full = tg.chunk_schedule(counts, chunk, 128)
    assert len(full) == 4 and full[0].shape == (chunk // 128,)
    sched = tuple(t.to(dev) for t in full[:2])
    g = torch.Generator(device=dev).manual_seed(k)
    lhs = torch.randn((chunk, k), generator=g, device=dev).bfloat16()
    rhs = (torch.randn((CHUNK_E, k, n), generator=g, device=dev)
           / k ** 0.5).bfloat16()
    dout = torch.randn((chunk, n), generator=g, device=dev).bfloat16()
    got = (tg.gmm_fwd(lhs, rhs, sched), tg.gmm_dx(dout, rhs, sched),
           tg.gmm_dw(lhs, dout, sched, num_experts=CHUNK_E))
    want = (tg.gmm_fwd_plain(lhs, rhs, sched),
            tg.gmm_dx_plain(dout, rhs, sched),
            tg.gmm_dw_plain(lhs, dout, sched, num_experts=CHUNK_E))
    torch.cuda.synchronize()
    live = int(tg._round_up(counts, 128).sum())
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        if kind == "empty":
            assert (a == 0).all() and (b == 0).all()
        else:
            _close(a, b, GMM_TOL[torch.bfloat16])
    assert (got[0][live:] == 0).all() and (got[1][live:] == 0).all()
    for x in range(CHUNK_E):
        if counts[x] == 0:
            assert (got[2][x] == 0).all(), x


# chip_smoke.DW_DRIFT_EXCESS: how far a kernel's drift along an f64
# product may exceed its plain version's (tools/gmm_mutants.py)
DW_DRIFT_EXCESS = 2e-6


def _drift(x, ref):
    d = x.double() - ref
    return ((d * ref).sum() / (ref * ref).sum()).item()


@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024)])
@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_gmm_fwd_dx_wgmma_drift(dev, kind, kn):
    """bf16 forward and dX at the MoE shapes on 16,384 rows routed to 32
    experts: against the plain version under GMM_TOL, and the drift along
    a product summed in f64 from the same operands within DW_DRIFT_EXCESS
    of the plain version's (each output sums K or N terms in the wgmma
    accumulator)."""
    k, n = kn
    counts = np.random.RandomState(5).multinomial(16384, [1 / 32] * 32)
    counts, m, sched, lhs, rhs, dout = _gmm_case(
        dev, torch.bfloat16, counts.tolist(), k, n, seed=7)
    a = lhs if kind == "fwd" else dout
    kern, plain = ((tg.gmm_fwd, tg.gmm_fwd_plain) if kind == "fwd"
                   else (tg.gmm_dx, tg.gmm_dx_plain))
    got, want = kern(a, rhs, sched), plain(a, rhs, sched)
    ref = torch.zeros(got.shape, dtype=torch.float64, device=dev)
    for rows, e in tg._live_tiles(sched, 128):
        w = rhs[e].double()
        ref[rows] = a[rows].double() @ (w if kind == "fwd" else w.T)
    torch.cuda.synchronize()
    _close(got, want, GMM_TOL[torch.bfloat16])
    assert abs(_drift(got, ref) - _drift(want, ref)) <= DW_DRIFT_EXCESS, \
        (_drift(got, ref), _drift(want, ref))


def test_gmm_dw_wgmma_one_expert_holds_every_row(dev):
    """bf16 dW when one expert holds 16,384 rows (128 tiles into one
    block) at the ERNIE phase's (K, N) = (1024, 512): against the plain
    version under GMM_TOL, and its drift along a product summed in f64
    from the same operands within DW_DRIFT_EXCESS of the plain
    version's."""
    counts, m, sched, lhs, _, dout = _gmm_case(
        dev, torch.bfloat16, [16384, 0, 0, 0], 1024, 512, seed=3,
        tail_tiles=0)
    got = tg.gmm_dw(lhs, dout, sched, num_experts=4)
    want = tg.gmm_dw_plain(lhs, dout, sched, num_experts=4)
    ref = lhs.double().T @ dout.double()
    torch.cuda.synchronize()
    _close(got, want, GMM_TOL[torch.bfloat16])
    assert (got[1:] == 0).all()
    assert abs(_drift(got[0], ref) - _drift(want[0], ref)) \
        <= DW_DRIFT_EXCESS, (_drift(got[0], ref), _drift(want[0], ref))


def test_gmm_autograd_on_card_matches_cpu(dev):
    counts, m, sched, lhs, rhs, dout = _gmm_case(
        dev, torch.float32, [70, 0, 200, 5], 128, 128, seed=4)
    out = []
    for d in ("cpu", dev):
        a = lhs.to(d).detach().requires_grad_()
        w = rhs.to(d).detach().requires_grad_()
        y = tg.grouped_matmul(a, w, tuple(s.to(d) for s in sched))
        y.backward(dout.to(d))
        out.append([t.detach().cpu() for t in (y, a.grad, w.grad)])
    # dW sums up to 200 rows of unit-scale products: held relative to
    # each row's scale, not to an absolute 1e-5
    for got, want in zip(out[1], out[0]):
        _close(got, want, GMM_TOL[torch.float32])


def test_gmm_kernels_reject_bad_inputs(dev):
    counts, m, sched, lhs, rhs, dout = _gmm_case(
        dev, torch.bfloat16, [3, 9], 128, 64)
    with pytest.raises(ValueError, match="tile_rows"):
        tg.gmm_fwd(lhs, rhs, tg.tile_schedule(counts.to(dev), m // 8,
                                              8)[:2], 8)
    with pytest.raises(ValueError, match="multiple"):
        tg.gmm_fwd(lhs[:, :64].contiguous(), rhs[:, :64].contiguous(), sched)
    with pytest.raises(TypeError):
        tg.gmm_fwd(lhs, rhs.float(), sched)
    with pytest.raises(ValueError):
        tg.gmm_fwd(lhs, rhs, tuple(s.cpu() for s in sched))


def test_moe_layer_on_card_matches_cpu(dev):
    """The dropless MoE layer (f32, 128-row tiles) through the kernels on
    the card against the plain versions on the CPU: output, aux and the
    gradients of x, the router logits, w1 and w2."""
    rng = np.random.RandomState(8)
    e, k, h, i, t = 8, 2, 128, 128, 300
    x = rng.randn(t, h).astype(np.float32)
    logits = rng.randn(t, e).astype(np.float32)
    w1 = (rng.randn(e, h, i) / h ** 0.5).astype(np.float32)
    w2 = (rng.randn(e, i, h) / i ** 0.5).astype(np.float32)
    cot = rng.randn(t, h).astype(np.float32)
    res = []
    for d in ("cpu", dev):
        leaves = [torch.from_numpy(a).to(d).requires_grad_()
                  for a in (x, logits, w1, w2)]
        o, aux = tmoe.moe_ragged_dispatch_combine(*leaves, e, k=k)
        torch.autograd.backward((o, aux), (torch.from_numpy(cot).to(d),
                                           torch.tensor(0.5, device=d)))
        res.append([v.detach().cpu() for v in [o, aux]
                    + [l.grad for l in leaves]])
    torch.testing.assert_close(res[1][1], res[0][1], rtol=1e-5, atol=0)
    for got, want in zip(res[1][:1] + res[1][2:], res[0][:1] + res[0][2:]):
        _close(got, want, GMM_TOL[torch.float32])


def test_ernie_train_steps_on_card_match_cpu(dev):
    """Three tiny fp32 ERNIE-MoE steps (the MoE slice's flags) through the
    kernels on the card and the plain versions on the CPU; each gmm
    kernel runs twice per MoE layer and step."""
    cfg = tm.ErnieMoEConfig(vocab_size=256, hidden_size=128,
                            intermediate_size=128, num_hidden_layers=4,
                            num_attention_heads=2, num_experts=8,
                            moe_topk=2, num_shared_experts=1,
                            max_position_embeddings=128,
                            dtype=torch.float32, dispatch_mode="ragged_a2a")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, size=(2, 96)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    flags = dict(multi_precision=False, with_stats=True,
                 active_only_moments=True)
    res = []
    for d in ("cpu", dev):
        step, _, _ = tm.build_train_step(cfg, device=d, **flags)
        params = tm.init_params(cfg, seed=1, device="cpu")
        params = {k: ({kind: {n: w.to(d) for n, w in s.items()}
                       for kind, s in v.items()} if k == "layers"
                      else v.to(d)) for k, v in params.items()}
        opt = tm._adamw_init(params, multi_precision=False)
        before = (tg.gmm_fwd.launches, tg.gmm_dx.launches,
                  tg.gmm_dw.launches)
        losses, rows = [], []
        for _ in range(3):
            params, opt, loss, st = step(params, opt, ids, labels)
            losses.append(float(loss))
            rows.append(st["moe_expert_rows"].cpu())
        res.append((losses, rows, (tg.gmm_fwd.launches - before[0],
                                   tg.gmm_dx.launches - before[1],
                                   tg.gmm_dw.launches - before[2])))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    for a, b in zip(res[1][1], res[0][1]):
        assert torch.equal(a, b)
    n_moe = cfg.num_hidden_layers // 2
    assert res[0][2] == (0, 0, 0)
    assert res[1][2] == (3 * 2 * n_moe,) * 3


# ---------------------------------------------------------------------------
# slab decode attention and generation
# ---------------------------------------------------------------------------

from paddle_tpu_torch.ops import decode_attention as da    # noqa: E402

# (rel, frob) of _close, the flash rule. bf16 P is rounded before P.V in
# both; an f32 sum in another order can move a P on a rounding boundary
# by one bf16 step.
SLAB_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -10)}


def _slab_case(dev, dtype, nh, nkv, hd, T=384, B=3, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = nkv * hd

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q = (torch.randn((B, nh, hd), generator=g, device=dev)
         * (da.LOG2E / hd ** 0.5)).to(dtype)
    return q, randn(B, kvd), randn(B, kvd), randn(2, B, kvd, T), \
        randn(2, B, kvd, T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_slab_kernels_match_plain(dev, dtype, hd, rep):
    """Rows 10 and 11 at pos 0, both sides of a tile edge and T - 1: the
    attention under the flash rule, the caches bitwise (the written
    column is new_k/new_v, every other column unchanged)."""
    q, nk, nv, kc, vc = _slab_case(dev, dtype, 2 * rep, 2, hd)
    for pos in (0, 127, 128, 300, 383):
        k0, v0 = kc.clone(), vc.clone()
        before = (da.decode_attend_update_slab.launches,
                  da.decode_attention_slab.launches)
        got_ro = da.decode_attention_slab(q, kc, vc, 1, pos)
        ref_ro = da.decode_attention_plain(q, k0, v0, 1, pos)
        kp, vp = kc.clone(), vc.clone()
        got = da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, pos)
        ref = da.decode_attend_update_plain(q, nk, nv, kp, vp, 1, pos)
        torch.cuda.synchronize()
        assert (da.decode_attend_update_slab.launches,
                da.decode_attention_slab.launches) == \
            (before[0] + 1, before[1] + 1)
        _close(got_ro, ref_ro, SLAB_TOL[dtype])
        _close(got, ref, SLAB_TOL[dtype])
        assert torch.equal(kc, kp) and torch.equal(vc, vp)
        assert torch.equal(kc[1, :, :, pos], nk)
        k0[1, :, :, pos], v0[1, :, :, pos] = nk, nv
        assert torch.equal(kc, k0) and torch.equal(vc, v0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1152, 5120])
def test_slab_split_kernels_across_split_boundaries(dev, dtype, T):
    """Rows 10 and 11 with the context split across CTAs (generate's B=8,
    NH=32 over NKV=4, HD=64): T = 1152 gives one tile a split, T = 5120
    several. At pos on both sides of every split boundary and at T - 1:
    the attention under the flash rule against the plain version with one
    split and with the kernel's split, the same bits over two runs, and
    the caches bitwise as the plain version leaves them."""
    nsplit = da.kernel_splits(8, 4, T, dev)
    run = da.split_tiles(T, nsplit) * da.TILE_T
    assert nsplit > 1
    q, nk, nv, kc, vc = _slab_case(dev, dtype, 32, 4, 64, T=T, B=8, seed=3)
    positions = sorted({p for c in range(run, T, run) for p in (c - 1, c)}
                       | {0, T - 1})
    for pos in positions:
        ro1 = da.decode_attention_slab(q, kc, vc, 1, pos)
        ro2 = da.decode_attention_slab(q, kc, vc, 1, pos)
        refs = [da.decode_attention_plain(q, kc, vc, 1, pos, n)
                for n in (1, nsplit)]
        kp, vp = kc.clone(), vc.clone()
        k2, v2 = kc.clone(), vc.clone()
        got = da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, pos)
        got2 = da.decode_attend_update_slab(q, nk, nv, k2, v2, 1, pos)
        ref = da.decode_attend_update_plain(q, nk, nv, kp, vp, 1, pos,
                                            nsplit)
        torch.cuda.synchronize()
        assert torch.equal(ro1, ro2) and torch.equal(got, got2), pos
        assert torch.equal(kc, kp) and torch.equal(vc, vp), pos
        assert torch.equal(k2, kp) and torch.equal(v2, vp), pos
        for r in refs:
            _close(ro1, r, SLAB_TOL[dtype])
        _close(got, ref, SLAB_TOL[dtype])
        _close(got, da.decode_attention_plain(q, kp, vp, 1, pos),
               SLAB_TOL[dtype])


def test_slab_launches_on_two_streams_keep_apart(dev):
    """Slab launches that overlap on two streams take the sync words of
    their own stream (ticket, done count, look-back flags): every launch
    gives the bits of a launch alone, and each stream's words come back
    to zero."""
    q, nk, nv, kc, vc = _slab_case(dev, torch.bfloat16, 32, 4, 64, T=1152,
                                   B=8, seed=4)
    want_ro = da.decode_attention_slab(q, kc, vc, 1, 700)
    k1, v1 = kc.clone(), vc.clone()
    want = da.decode_attend_update_slab(q, nk, nv, k1, v1, 1, 700)
    streams = [torch.cuda.Stream(q.device) for _ in range(2)]
    caches = [(kc.clone(), vc.clone()) for _ in streams]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(q.device))
    outs = []
    for _ in range(50):
        for s, (k, v) in zip(streams, caches):
            with torch.cuda.stream(s):
                outs.append((da.decode_attention_slab(q, kc, vc, 1, 700),
                             da.decode_attend_update_slab(q, nk, nv, k, v,
                                                          1, 700)))
    torch.cuda.synchronize()
    for ro, up in outs:
        assert torch.equal(ro, want_ro) and torch.equal(up, want)
    for s, (k, v) in zip(streams, caches):
        assert torch.equal(k, k1) and torch.equal(v, v1)
        assert not da._SYNC[(q.device, s.cuda_stream)].any()


# Row 10's output bits at generate's shape (B 8, NH 32 over NKV 4, HD 64,
# T 1152, bf16; read-only at pos 1023, then the update at pos 700), as the
# slab kernel gave them before its split protocol moved into
# csrc/split_common.cuh (recorded on an NVIDIA H100 80GB HBM3 with CUDA
# 12.8): the move must not change them.
ROW10_BITS = "5039074f6b5f73b8"


def _row10_bits(dev):
    """sha256 (16 hex digits) of row 10's and row 11's outputs on seeded
    numpy inputs."""
    import hashlib
    rng = np.random.RandomState(10)
    b, nh, nkv, hd, t_len = 8, 32, 4, 64, 1152
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dev, torch.bfloat16)
    q = t(rng.randn(b, nh, hd) * (da.LOG2E / hd ** 0.5))
    nk, nv = t(rng.randn(b, nkv * hd)), t(rng.randn(b, nkv * hd))
    kc, vc = (t(rng.randn(2, b, nkv * hd, t_len)) for _ in range(2))
    ro = da.decode_attention_slab(q, kc, vc, 1, 1023)
    up = da.decode_attend_update_slab(q, nk, nv, kc, vc, 1, 700)
    h = hashlib.sha256()
    for x in (ro, up):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def test_slab_kernel_keeps_its_bits(dev):
    assert _row10_bits(dev) == ROW10_BITS


def test_slab_kernels_reject_bad_inputs(dev):
    q, nk, nv, kc, vc = _slab_case(dev, torch.float32, 4, 2, 32)
    with pytest.raises(ValueError, match="multiple of 128"):
        da.decode_attention_slab(q, kc[..., :200].contiguous(),
                                 vc[..., :200].contiguous(), 0, 5)
    with pytest.raises(ValueError, match="NH/NKV"):
        da.decode_attention_slab(q.repeat(1, 8, 1).contiguous(), kc, vc, 0, 5)
    with pytest.raises(ValueError, match="device"):
        da.decode_attend_update_slab(q.cpu(), nk, nv, kc, vc, 0, 5)
    with pytest.raises(TypeError):
        da.decode_attention_slab(q.to(torch.bfloat16), kc, vc, 0, 5)


@pytest.mark.parametrize("hidden", [64, 256])     # head_dim 32 and 128
def test_generation_on_card_matches_cpu(dev, hidden):
    """Tiny fp32 greedy and beam streams through the kernels on the card
    equal the CPU's through the plain versions, on the slab cache (head_dim
    32) and the head-major cache (head_dim 128)."""
    cfg = tl.llama_tiny(vocab=64, hidden=hidden, layers=2, heads=2,
                        kv_heads=1, inter=64, seq=512)
    params = tl.init_llama_params(cfg, seed=1, device="cpu")
    prompt = np.random.RandomState(0).randint(0, 64, (2, 126)).astype(np.int32)
    out = []
    for d in ("cpu", dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        before = da.decode_attend_update_slab.launches
        greedy = tl.greedy_generate(p, prompt, cfg, 6, device=d)
        seqs, scores = tl.beam_search_generate(p, prompt, cfg, 5, num_beams=3,
                                               eos_token_id=3,
                                               length_penalty=0.6, device=d)
        out.append((greedy, seqs, scores,
                    da.decode_attend_update_slab.launches - before))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_allclose(out[1][2], out[0][2], atol=1e-5, rtol=0)
    launches = 2 * (5 + 4) if hidden == 64 else 0     # layers x steps
    assert (out[0][3], out[1][3]) == (0, launches)


# ---------------------------------------------------------------------------
# packed varlen attention (rows 19-23)
# ---------------------------------------------------------------------------

VARLEN_LAYOUTS = [
    # single-token segments among longer ones (a pack of single tokens
    # alone has dq = dk = 0 in exact arithmetic: rounding noise only)
    ([1, 1, 1, 40, 1, 1, 1, 30, 1], None),
    ([64, 128, 64], None),              # segment ends on tile edges
    ([100, 61, 139], None),             # a padded tail (300 tokens)
    ([64, 0, 100, 0, 31], None),        # empty segments
    ([1, 128, 3, 257, 1], None),        # mixed
    ([40, 8, 30], [64, 0, 32]),         # cross: an empty k segment
    ([50, 20, 90], [30, 70, 90]),       # cross: len_q != len_k
    # segments that straddle the wgmma kernels' 128-row tiles and end
    # inside a warpgroup's 64 rows
    ([127, 129, 1, 255], None),
    ([127, 129, 1, 255], [130, 1, 127, 200]),
]


def _varlen_case(dev, dtype, lens_q, lens_k, h, d, seed, packed=True):
    """[H, T, D] operands (views of packed [T, H, D], or contiguous) and
    cu on the card; the k side is the q side's cu object for
    self-attention."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cu_q = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]),
                        dtype=torch.int32, device=dev)
    cu_k = cu_q if lens_k is None else torch.tensor(
        np.concatenate([[0], np.cumsum(lens_k)]), dtype=torch.int32,
        device=dev)
    tq, tk = sum(lens_q), sum(lens_q if lens_k is None else lens_k)

    def make(t):
        x = torch.randn((t, h, d), generator=g, device=dev).to(dtype)
        return x.transpose(0, 1) if packed else x.transpose(0, 1).contiguous()
    return make(tq), make(tk), make(tk), make(tq), cu_q, cu_k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("layout", range(len(VARLEN_LAYOUTS)))
def test_varlen_kernels_match_plain(dev, dtype, d, causal, packed, layout):
    """Every varlen kernel against its plain version (bf16: rows 20-23 on
    wgmma) in both memory layouts; in bf16 the fused dK and dV are the
    split pair's bits (one kernel body)."""
    lens_q, lens_k = VARLEN_LAYOUTS[layout]
    q, k, v, do, cu_q, cu_k = _varlen_case(dev, dtype, lens_q, lens_k, 3, d,
                                           layout, packed=packed)
    scale = d ** -0.5
    (tol_f, tol_b) = FLASH_TOL[dtype]
    before = (fv.varlen_fwd.launches, fv.varlen_bwd.launches,
              fv.varlen_bwd_dkv.launches, fv.varlen_bwd_dq.launches)
    o, lse = fv.varlen_fwd(q, k, v, cu_q, cu_k, causal, scale)
    o_ref, lse_ref = fv.varlen_fwd_plain(q, k, v, cu_q, cu_k, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse_ref, delta, cu_q, cu_k, causal, scale)
    fused = fv.varlen_bwd(*args)
    split = fv.varlen_bwd_dq(*args), *fv.varlen_bwd_dkv(*args)
    want = fv.varlen_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (fv.varlen_fwd.launches, fv.varlen_bwd.launches,
            fv.varlen_bwd_dkv.launches, fv.varlen_bwd_dq.launches) == \
        tuple(b + 1 for b in before)
    assert o.stride() == q.stride() and fused[0].stride() == q.stride()
    _close(o, o_ref, tol_f)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    for got in (fused, split):
        for a, b in zip(got, want):
            _close(a, b, tol_b)
    if dtype == torch.bfloat16:
        assert torch.equal(fused[1], split[1]) and torch.equal(fused[2],
                                                               split[2])
    if lens_k is not None and 0 in lens_k:
        s = lens_k.index(0)
        r0, r1 = sum(lens_q[:s]), sum(lens_q[:s + 1])
        for x in (o, fused[0], split[0]):
            assert (x[:, r0:r1] == 0).all()
        assert (lse[:, r0:r1] == 0).all()


def test_varlen_fused_and_split_agree_and_split_dq_is_deterministic(dev):
    """At the short pack's head width in bf16: fused and split within the
    bf16 limits, the fused dK and dV bitwise equal to the split pair's
    (one kernel body); the split dQ, dK and dV (no atomics) bitwise equal
    over two runs."""
    lens = [300, 77, 1000, 64, 511]
    q, k, v, do, cu, _ = _varlen_case(dev, torch.bfloat16, lens, None, 8,
                                      128, 5)
    o, lse = fv.varlen_fwd(q, k, v, cu, cu, True, 128 ** -0.5)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, cu, cu, True, 128 ** -0.5)
    dq1 = fv.varlen_bwd_dq(*args)
    dq2 = fv.varlen_bwd_dq(*args)
    dkv1 = fv.varlen_bwd_dkv(*args)
    dkv2 = fv.varlen_bwd_dkv(*args)
    fused = fv.varlen_bwd(*args)
    split = (dq1, *dkv1)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    assert torch.equal(dkv1[0], dkv2[0]) and torch.equal(dkv1[1], dkv2[1])
    assert torch.equal(fused[1], dkv1[0]) and torch.equal(fused[2], dkv1[1])
    for a, b in zip(fused, split):
        _close(a, b, FLASH_TOL[torch.bfloat16][1])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_varlen_split_wgmma_long_segment_matches_plain(dev, d, packed, causal):
    """The bf16 kernels on wgmma (rows 20-23: the forward, the fused and
    the split backward) on a pack with a segment over 4,096 tokens, among
    short ones that end inside a 128-row tile, against the plain versions
    under the bf16 limits (lse to 1e-4)."""
    lens = [300, 4500, 77, 1000, 13]
    q, k, v, do, cu, _ = _varlen_case(dev, torch.bfloat16, lens, None, 2, d,
                                      11, packed=packed)
    scale = d ** -0.5
    o, lse = fv.varlen_fwd_plain(q, k, v, cu, cu, causal, scale)
    o_k, lse_k = fv.varlen_fwd(q, k, v, cu, cu, causal, scale)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, cu, cu, causal, scale)
    split = (fv.varlen_bwd_dq(*args), *fv.varlen_bwd_dkv(*args))
    fused = fv.varlen_bwd(*args)
    want = fv.varlen_bwd_plain(*args)
    torch.cuda.synchronize()
    assert o_k.stride() == q.stride()
    _close(o_k, o, FLASH_TOL[torch.bfloat16][0])
    torch.testing.assert_close(lse_k, lse, atol=1e-4, rtol=0)
    for got in (split, fused):
        assert got[0].stride() == q.stride() and got[1].stride() == k.stride()
        for a, b in zip(got, want):
            _close(a, b, FLASH_TOL[torch.bfloat16][1])


def test_varlen_segments_are_isolated(dev):
    """Changing one segment's k and v leaves every other segment's o, dq,
    dk and dv bitwise the same: o and the fused and split dK/dV, and the
    split dQ; the fused dQ sums across CTAs by atomics in an order that
    varies from run to run, so it is held within the bf16 limits."""
    lens = [130, 64, 200, 7, 99]
    q, k, v, do, cu, _ = _varlen_case(dev, torch.bfloat16, lens, None, 4,
                                      128, 9)
    seg = slice(130, 194)                 # segment 1
    k2, v2 = k.clone(), v.clone()
    k2[:, seg] = -k2[:, seg] * 3
    v2[:, seg] = v2[:, seg] + 1

    def run(k, v):
        o, lse = fv.varlen_fwd(q, k, v, cu, cu, True, 0.1)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        args = (q, k, v, do, lse, delta, cu, cu, True, 0.1)
        dq_fused, dk, dv = fv.varlen_bwd(*args)
        return (o, dk, dv, fv.varlen_bwd_dq(*args),
                *fv.varlen_bwd_dkv(*args)), dq_fused

    (a, dq_a), (b, dq_b) = run(k, v), run(k2, v2)
    torch.cuda.synchronize()
    keep = torch.ones(sum(lens), dtype=torch.bool, device=dev)
    keep[seg] = False
    for x, y in zip(a, b):
        assert torch.equal(x[:, keep], y[:, keep])
    _close(dq_b[:, keep], dq_a[:, keep], FLASH_TOL[torch.bfloat16][1])
    assert not torch.equal(a[0][:, seg], b[0][:, seg])


def test_flash_attn_unpadded_on_card_matches_cpu(dev):
    """The public entry through the kernels (GQA 4/2, causal, bf16 cast
    off) against the CPU's padded-batch branch, forward and backward,
    f32."""
    import paddle_tpu_torch.nn.functional as F
    lens = [70, 58, 1, 100]
    rng = np.random.RandomState(3)
    t = sum(lens)
    host = [torch.from_numpy(rng.randn(t, h, 64).astype(np.float32))
            for h in (4, 2, 2)]
    do = torch.from_numpy(rng.randn(t, 4, 64).astype(np.float32))
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    out = []
    for d in ("cpu", dev):
        x = [a.to(d, copy=True).requires_grad_() for a in host]
        c = cu.to(d)
        before = fv.varlen_fwd.launches
        o, _ = F.flash_attn_unpadded(*x, c, c, max(lens), max(lens),
                                     causal=True)
        o.backward(do.to(d))
        out.append([o.detach().cpu()] + [a.grad.cpu() for a in x]
                   + [fv.varlen_fwd.launches - before])
    assert (out[0][-1], out[1][-1]) == (0, 1)
    for a, b in zip(out[1][:-1], out[0][:-1]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_seq,dropout", [(1100, 0.0), (5, 0.1)])
def test_flash_attn_unpadded_on_card_takes_the_kernels_past_jax_gate(
        dev, n_seq, dropout):
    """1024 sequences or more, or dropout > 0 (ignored on both branches),
    still run the varlen kernels on the card: JAX's gate belongs to its
    TPU segment codes. Held to the CPU's padded-batch branch, f32, 1e-4."""
    import paddle_tpu_torch.nn.functional as F
    rng = np.random.RandomState(n_seq)
    lens = list(rng.randint(0, 4, n_seq))
    t = sum(lens)
    q, k, v = (torch.from_numpy(rng.randn(t, 2, 64).astype(np.float32))
               for _ in range(3))
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32)
    out = []
    for d in ("cpu", dev):
        c = cu.to(d)
        before = fv.varlen_fwd.launches
        o, _ = F.flash_attn_unpadded(q.to(d), k.to(d), v.to(d), c, c,
                                     max(lens), max(lens), dropout=dropout,
                                     causal=True)
        out.append((o.cpu(), fv.varlen_fwd.launches - before))
    assert (out[0][1], out[1][1]) == (0, 1)
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-4, rtol=1e-4)


def test_varlen_kernels_reject_bad_inputs(dev):
    lens = [10, 20]
    q, k, v, do, cu, _ = _varlen_case(dev, torch.bfloat16, lens, None, 2,
                                      128, 0)
    for dtype, d in ((torch.float16, 128), (torch.bfloat16, 96)):
        x = torch.zeros((2, 30, d), dtype=dtype, device=dev)
        with pytest.raises((TypeError, ValueError)):
            fv.varlen_fwd(x, x, x, cu, cu, True, 0.1)
    with pytest.raises(TypeError):
        fv.varlen_fwd(q, k, v, cu.long(), cu.long(), True, 0.1)
    with pytest.raises(ValueError):
        fv.varlen_fwd(q, k.contiguous(), v, cu, cu, True, 0.1)  # mixed forms
    with pytest.raises(ValueError):
        fv.varlen_fwd(q[:, ::2], k[:, ::2], v[:, ::2], cu, cu, True, 0.1)


# -- the serving engine's own device work --------------------------------


def _tiny_engine(dev, **serve):
    from paddle_tpu_torch.inference import InferenceEngine, ServeConfig
    cfg = tl.llama_tiny(vocab=96, hidden=128, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=3, device=dev)
    kw = dict(block_size=128, num_blocks=12, max_batch=2, prefill_chunk=64,
              max_seq_len=512)
    kw.update(serve)
    return InferenceEngine(params, cfg, ServeConfig(**kw), device=dev)


@pytest.mark.parametrize("serve", [
    dict(prefix_cache=True), dict(prefix_cache=True, kv_dtype="int8"),
    dict(prefix_cache=True, speculative=True, draft_k=2)],
    ids=["bf16-pools", "int8", "draft"])
def test_cow_blit_copies_every_pool_slab(dev, serve):
    """_cow_span on a genuinely shared block: the writer's private copy of
    every pool (base, scales, draft) is bitwise the shared block's, and
    the readers' bytes do not move."""
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.inference.engine import _Seq
    eng = _tiny_engine(dev, **serve)
    prompt = np.random.RandomState(1).randint(1, 96, size=300).tolist()
    eng.run([Request(prompt, max_new_tokens=3)], deterministic=True)
    hit = eng.cache.match(prompt, 2)
    assert len(hit) == 2
    eng.pool.acquire(hit)
    eng.pool.acquire(hit)
    b = hit[0]
    pools = [p for p in (eng.k_pool, eng.v_pool, eng.k_scale, eng.v_scale,
                         eng.k_draft, eng.v_draft) if p is not None]
    before = [p[:, b].clone() for p in pools]
    writer = _Seq(Request(prompt, max_new_tokens=1, request_id=99), 0.0)
    writer.blocks = list(hit)
    assert eng._cow_span(writer, 0, 1)
    torch.cuda.synchronize()
    nb = writer.blocks[0]
    assert nb != b and eng.pool.ref_count(b) == 1
    for p, was in zip(pools, before):
        assert torch.equal(p[:, b], was) and torch.equal(p[:, nb], was)


def test_dead_columns_never_reach_rows_2_to_7(dev):
    """chip_smoke's check: rows 2-7 over NaN in every dead column (past
    each row's last token, and null block 0) give bitwise the outputs of
    zero dead columns."""
    from chip_smoke import check_dead_columns
    assert all(check_dead_columns(dev).values())


def test_a_cuda_error_in_a_step_propagates(dev, monkeypatch):
    """A failure of the device work inside a step (here a real one: the
    caching allocator's out-of-memory error, raised mid-decode) is never
    quarantined: it propagates, run() leaves a leak-free pool, and the
    engine serves again after it."""
    from paddle_tpu_torch.inference import Request
    import paddle_tpu_torch.inference.engine as emod
    eng = _tiny_engine(dev)
    real = emod.llama_paged_decode_step
    calls = []

    def step(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        return real(*a, **k)
    monkeypatch.setattr(emod, "llama_paged_decode_step", step)
    reqs = [Request(np.random.RandomState(i).randint(1, 96, size=40)
                    .tolist(), max_new_tokens=4) for i in range(2)]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run(reqs, deterministic=True)
    assert not eng.failed and eng.pool.used_blocks == 0
    assert eng._pools_alive()
    stats = eng.run([], deterministic=True)
    assert stats["requests"] == 2 and not eng.failed


# ---------------------------------------------------------------------------
# the rest of single-device training: remat policies, plain attention,
# chunked cross entropy, capacity dispatch, the non-split ERNIE stack
# ---------------------------------------------------------------------------

POLICIES = ["full", "dots", "save_attn", "save_mlp", "offload_attn"]


def _policy_model():
    cfg = tl.llama_tiny(vocab=96, hidden=256, layers=2, heads=2, kv_heads=2,
                        inter=512, seq=256)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 96, size=(2, 256)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return cfg, ids, labels


@pytest.mark.parametrize("use_flash", [None, False])
def test_remat_policies_launch_and_match_full_on_card(dev, use_flash,
                                                      monkeypatch):
    """Each policy on the card (f32, head_dim 128), flash and plain, under
    the split flash backward (no atomics): the loss bitwise full's (the
    forward is the same work), the gradients within 1e-5 of full's, the
    launches of rows 1 and 14 and of the backward as
    chip_smoke.step_launches says (rows 17 and 18 in place of row 16),
    and offload_attn sending what it keeps of every layer to the host and
    back."""
    from chip_smoke import step_launches
    monkeypatch.setenv(fa.ENV_FLASH_BWD, "split")
    cfg, ids, labels = _policy_model()
    params = tl.init_llama_params(cfg, seed=1, device=dev)
    L = cfg.num_hidden_layers
    ids_t = torch.from_numpy(ids).to(dev)
    labels_t = torch.from_numpy(labels).to(dev)
    ref = None
    for policy in POLICIES:
        par = tl.ParallelConfig(remat_policy=policy, use_flash=use_flash)
        before = (fused_rms_norm.launches, fa.flash_fwd.launches,
                  fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches,
                  fa.flash_bwd.launches)
        tl.park_on_host.bytes = 0
        loss, grads = tl.llama_loss_and_grads(params, ids_t, labels_t, cfg,
                                              par)
        torch.cuda.synchronize()
        dkv = fa.flash_bwd_dkv.launches - before[2]
        assert fa.flash_bwd_dq.launches - before[3] == dkv
        assert fa.flash_bwd.launches == before[4]
        got = {"rms_norm": fused_rms_norm.launches - before[0],
               "flash_fwd": fa.flash_fwd.launches - before[1],
               "flash_bwd": dkv}
        want = step_launches(L, policy, use_flash)
        assert got == want, (policy, got, want)
        flat = [t for v in grads["layers"].values() for t in v] + \
            [grads["embed"], grads["lm_head"], grads["final_norm"]]
        if ref is None:
            ref = (loss, flat)
        else:
            assert torch.equal(loss, ref[0]), policy
            for g, r in zip(flat, ref[1]):
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        # B 2 x NH 2 x S 256 rows of o (128 f32) and lse (one f32) a
        # layer; the plain path parks its [B, S, NH*HD] copy instead
        row = 128 * 4 + (4 if use_flash is not False else 0)
        parked = L * 2 * 2 * 256 * row if policy == "offload_attn" else 0
        assert tl.park_on_host.bytes == parked, policy


def test_chunked_ce_on_card_matches_cpu(dev):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 203, 256).astype(np.float32)
    head = (rng.randn(256, 1000) * 0.05).astype(np.float32)
    labels = rng.randint(0, 1000, (2, 203))
    labels[1, :9] = -100
    res = []
    for d in ("cpu", dev):
        xs = torch.from_numpy(x).to(d).requires_grad_()
        hs = torch.from_numpy(head).to(d).requires_grad_()
        loss = tl.chunked_ce_loss(xs, hs, torch.from_numpy(labels).to(d))
        loss.backward()
        res.append([t.detach().cpu() for t in (loss, xs.grad, hs.grad)])
    torch.testing.assert_close(res[1][0], res[0][0], rtol=1e-5, atol=0)
    for got, want in zip(res[1][1:], res[0][1:]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("onehot", [False, True])
def test_capacity_dispatch_on_card_matches_cpu(dev, onehot):
    """The capacity slot schedule (and its one-hot form) in f32 on the card
    against the CPU, under a skew that drops pairs: output, aux, stats
    (bitwise) and the gradients of x, the router logits, w1 and w2."""
    rng = np.random.RandomState(9)
    e, k, h, i, t = 4, 2, 64, 128, 320
    x = rng.randn(t, h).astype(np.float32)
    logits = rng.randn(t, e).astype(np.float32)
    logits[:, 0] += 2.0
    w1 = (rng.randn(e, h, i) / h ** 0.5).astype(np.float32)
    w2 = (rng.randn(e, i, h) / i ** 0.5).astype(np.float32)
    res = []
    for d in ("cpu", dev):
        leaves = [torch.from_numpy(a).to(d).requires_grad_()
                  for a in (x, logits, w1, w2)]
        o, aux, st = tmoe.moe_dispatch_combine(
            *leaves, e, k=k, capacity_factor=0.5, use_onehot=onehot,
            return_stats=True, dispatch_mode="capacity")
        ((o ** 2).sum() + aux).backward()
        res.append(([v.detach().cpu() for v in [o, aux]
                     + [l.grad for l in leaves]],
                    {n: v.cpu() for n, v in st.items()}))
    assert float(res[0][1]["moe_dropped_tokens"]) > 0
    for n in res[0][1]:
        assert torch.equal(res[1][1][n], res[0][1][n]), n
    for got, want in zip(res[1][0], res[0][0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_non_split_ernie_steps_on_card_match_cpu(dev):
    """Three tiny fp32 ERNIE-MoE steps on the non-split stack (every layer
    MoE, capacity by default) on the card and the CPU: losses, routing
    counts, and the flash launches of a stack recomputed in the
    backward."""
    import dataclasses
    cfg = tm.ErnieMoEConfig(vocab_size=256, hidden_size=128,
                            intermediate_size=128, num_hidden_layers=3,
                            num_attention_heads=2, num_experts=4,
                            moe_topk=2, moe_every=1,
                            max_position_embeddings=128,
                            dtype=torch.float32)
    cfg = dataclasses.replace(cfg, dispatch_mode=None)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, size=(2, 96)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    res = []
    for d in ("cpu", dev):
        step, _, _ = tm.build_train_step(cfg, device=d, with_stats=True)
        params = tm.init_params(cfg, seed=1, device="cpu")
        params = {k: ({n: w.to(d) for n, w in v.items()}
                      if k == "layers" else v.to(d))
                  for k, v in params.items()}
        opt = tm._adamw_init(params)
        before = fa.flash_fwd.launches
        losses, counts = [], []
        for _ in range(3):
            params, opt, loss, st = step(params, opt, ids, labels)
            losses.append(float(loss))
            counts.append(float(st["moe_routed_tokens"]))
        res.append((losses, counts, fa.flash_fwd.launches - before))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    assert res[1][1] == res[0][1]
    assert res[0][2] == 0 and res[1][2] == 3 * 2 * cfg.num_hidden_layers


# ---------------------------------------------------------------------------
# checkpoint save/load and the serving fleet on the card
# ---------------------------------------------------------------------------

def _card_state(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    return {"w": torch.randn(257, 129, generator=g, device=dev)
            .to(torch.bfloat16),
            "opt": {"m": torch.randn(257, 129, generator=g, device=dev),
                    "t": torch.ones((), device=dev)},
            "i": torch.arange(7, device=dev, dtype=torch.int32), "step": 3}


def test_checkpoint_round_trip_of_cuda_tensors_is_bitwise(dev, tmp_path):
    """A save of CUDA tensors restores bitwise into a card template (the
    same tensors, the same storage) and into a CPU template, and the
    restored leaves hash to the manifest's checksums."""
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    state = _card_state(dev)
    path = str(tmp_path / "ck")
    sl.save_state_dict(state, path, manifest={"step": 3})
    man = sl.load_manifest(path)
    assert man["leaf_checksums"] == sl.leaf_checksums(state)
    for where in (dev, "cpu"):
        tmpl = {"w": torch.zeros(257, 129, dtype=torch.bfloat16,
                                 device=where),
                "opt": {"m": torch.zeros(257, 129, device=where),
                        "t": torch.zeros((), device=where)},
                "i": torch.zeros(7, dtype=torch.int32, device=where),
                "step": 0}
        ptrs = [tmpl["w"].data_ptr(), tmpl["opt"]["m"].data_ptr()]
        sl.load_state_dict(tmpl, path)
        assert [tmpl["w"].data_ptr(), tmpl["opt"]["m"].data_ptr()] == ptrs
        assert tmpl["w"].device.type == torch.device(where).type
        for a, b in ((tmpl["w"], state["w"]),
                     (tmpl["opt"]["m"], state["opt"]["m"]),
                     (tmpl["opt"]["t"], state["opt"]["t"]),
                     (tmpl["i"], state["i"])):
            assert torch.equal(a.cpu(), b.cpu())
        assert int(tmpl["step"]) == 3
        assert sl.leaf_checksums(tmpl) == man["leaf_checksums"]


def test_checkpoint_snapshot_isolated_from_an_update_right_after(dev,
                                                                 tmp_path):
    """An in-place AdamW update launched on the card right after an async
    save returns never reaches the checkpoint: the snapshot is a complete
    host copy when save_state_dict returns."""
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    cfg = tl.llama_tiny(vocab=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, seq=256)
    params = tl.init_llama_params(cfg, seed=1, device=dev)
    state = {"params": params, "opt": tl._adamw_init(params), "step": 1}
    want = sl.leaf_checksums(state)
    grads = {k: ({kk: torch.full_like(vv, 0.25) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.full_like(v, 0.25))
             for k, v in params.items()}
    h = sl.save_state_dict(state, str(tmp_path / "ck"), async_save=True,
                           manifest={"step": 1})
    tl._adamw_update(params, grads, state["opt"], 1e-2)
    torch.cuda.synchronize()
    assert sl.leaf_checksums(state) != want
    h.wait()
    assert sl.load_manifest(str(tmp_path / "ck"))["leaf_checksums"] == want
    fresh = tl.init_llama_params(cfg, seed=2, device=dev)
    tmpl = {"params": fresh, "opt": tl._adamw_init(fresh), "step": 0}
    sl.load_state_dict(tmpl, str(tmp_path / "ck"))
    assert sl.leaf_checksums(tmpl) == want


def test_tiny_fleet_on_card_matches_cpu(dev, tmp_path):
    """A tiny fp32 fleet of 3 replicas on the card, with a replica killed
    mid-trace (journals on) and a rolling swap from a CheckpointManager
    root: routing, streams and outcomes equal the same fleet's on the CPU,
    and the card run launched rows 1 and 3."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.inference import FleetRouter, Request, ServeConfig
    from paddle_tpu_torch.ops import rms_norm as rn
    cfg = tl.llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=3, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "root"), keep=1)
    mgr.save({"params": params, "step": 1}, 1, block=True)
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 90, size=140).tolist()
    prompts = [shared + rng.randint(1, 90, size=8).tolist() if i % 2 == 0
               else rng.randint(1, 90, size=24).tolist() for i in range(8)]
    out = []
    for side, d in enumerate(("cpu", dev)):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(d)) for k, v in params.items()}
        jd = tmp_path / f"journals{side}"
        jd.mkdir()
        fleet = FleetRouter(p, cfg, ServeConfig(
            block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
            max_seq_len=256, prefix_cache=True), n_replicas=3,
            journal_dir=str(jd), device=d)
        pa.paged_attend_update.launches = 0
        rn.fused_rms_norm.launches = 0
        stats = fleet.run([Request(pr, max_new_tokens=5, arrival=float(i))
                           for i, pr in enumerate(prompts)],
                          deterministic=True, kill_at=(4, 1),
                          rolling_swap_at=2, swap_source=mgr.root)
        out.append((fleet.routing_log, fleet.streams(), fleet.outcomes(),
                    stats, pa.paged_attend_update.launches,
                    rn.fused_rms_norm.launches))
    (log0, s0, o0, st0, n0, r0), (log1, s1, o1, st1, n1, r1) = out
    assert (log0, s0, o0, st0) == (log1, s1, o1, st1)
    assert st1["lost"] == 0 and st1["migrations"] > 0 and \
        st1["rolling_swaps"] == 2
    assert n0 == r0 == 0 and n1 > 0 and r1 > 0


def _resume_model(dev):
    """A bf16 Llama at head_dim 128 whose attention runs the card's flash
    kernels at S 1024 (eight 128-key blocks: row 16 sums dQ over them)."""
    cfg = tl.llama_tiny(vocab=512, hidden=512, layers=2, heads=4, kv_heads=4,
                        inter=1024, seq=1024)
    cfg.dtype = torch.bfloat16
    rng = np.random.RandomState(13)
    batches = [rng.randint(0, 512, size=(2, 1025)).astype(np.int32)
               for _ in range(4)]
    return cfg, batches


def _run_steps(step, state, batches):
    losses = []
    for x in batches:
        state["params"], state["opt"], loss = step(
            state["params"], state["opt"], x[:, :-1], x[:, 1:])
        losses.append(float(loss))
    return losses


def test_resume_under_split_is_bitwise(dev, tmp_path, monkeypatch):
    """Under PADDLE_TPU_TORCH_FLASH_BWD=split (rows 17 and 18: dQ summed
    in a fixed order) four straight steps equal two steps, a
    CheckpointManager save, a restore into a state of another seed and two
    more steps, bit for bit: losses and every param and moment."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.checkpoint import save_load as sl
    monkeypatch.setenv(fa.ENV_FLASH_BWD, "split")
    cfg, batches = _resume_model(dev)
    step, params, opt = tl.build_train_step(cfg, tl.ParallelConfig(),
                                            seed=1, device=dev)
    straight = {"params": params, "opt": opt}
    want = _run_steps(step, straight, batches)
    step, params, opt = tl.build_train_step(cfg, tl.ParallelConfig(),
                                            seed=1, device=dev)
    first = {"params": params, "opt": opt}
    got = _run_steps(step, first, batches[:2])
    mgr = CheckpointManager(str(tmp_path / "root"), keep=1)
    mgr.save(first, 2, block=True)
    step, params, opt = tl.build_train_step(cfg, tl.ParallelConfig(),
                                            seed=2, device=dev)
    resumed = {"params": params, "opt": opt}
    assert mgr.restore(resumed) == 2
    got += _run_steps(step, resumed, batches[2:])
    assert got == want
    assert sl.leaf_checksums(resumed) == sl.leaf_checksums(straight)


def test_default_flash_backward_gap_between_two_runs(dev, monkeypatch):
    """The default backward (auto: row 16, dQ by bulk reduce-adds in an
    order the hardware picks) is not bitwise run-to-run by construction;
    split (rows 17 and 18) is. Eight backward calls on the same inputs at
    the train shape (B 4 x NH 32, S 2048, D 128, causal, bf16): dK and dV
    bitwise the first call's under both; dQ bitwise under split and,
    under auto, within 2^-7 relative Frobenius of the first call's, the
    calls that differ and the largest gap printed."""
    g = torch.Generator(device=dev).manual_seed(5)
    bh, s, d = 128, 2048, 128
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    qs = fa._prescale(q, scale)
    o, lse = fa.flash_fwd(qs, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    for mode in ("split", "auto"):
        monkeypatch.setenv(fa.ENV_FLASH_BWD, mode)
        first = fa._bwd_calls(qs, k, v, do, lse, delta, True, scale)
        gaps = []
        for _ in range(7):
            dq, dk, dv = fa._bwd_calls(qs, k, v, do, lse, delta, True, scale)
            assert torch.equal(dk, first[1]) and torch.equal(dv, first[2])
            gaps.append(float((dq.float() - first[0].float()).norm()
                              / first[0].float().norm()))
        print(f"{mode}: dQ of 7 more calls against the first, rel frob "
              f"{gaps}; {sum(x > 0 for x in gaps)} differ")
        if mode == "split":
            assert not any(gaps), gaps
        else:
            assert max(gaps) < 2 ** -7, gaps


@pytest.mark.parametrize("bh", [64, 32])
def test_flash_kernels_at_the_mp2_heads(dev, bh):
    """Rows 14 and 16 at a rank's shape under mp 2 (llama_7b's 32 heads
    over 2 ranks: B 4, and 2 rows a rank under dp 2 x mp 2, x 16 heads),
    S 2048, D 128, causal, bf16, against their plain versions under the
    flash rule."""
    qs, k, v, do = _flash_case(dev, torch.bfloat16, bh, 2048, 128, seed=bh)
    tol_f, tol_b = FLASH_TOL[torch.bfloat16]
    o, lse = fa.flash_fwd(qs, k, v, True)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    got = fa.flash_bwd(qs, k, v, do, lse_ref, delta, True, 128 ** -0.5)
    want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, delta, True,
                              128 ** -0.5)
    torch.cuda.synchronize()
    _close(o, o_ref, tol_f)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g_).all(), name
        _close(g_, w_, tol_b)


def test_rings_on_cuda_tensors_over_gloo_are_bitwise_the_blocking_path(
        dev, tmp_path):
    """Two ranks on the card joined over gloo (which takes no CUDA tensor
    point-to-point: the hop stages through the host) at mp 2, bf16: a
    ring hop brings the previous rank's tensor; the row-parallel ring
    all-reduce matmul, the column-parallel gather ring, the bare rings
    (unchunked and in 4 sub-tiles a hop), the fused FFN plan and the
    vocabulary-parallel embedding plan give their blocking counterparts'
    outputs and gradients bit for bit (cuBLAS on a ring's row chunks and
    on the whole rows)."""
    from paddle_tpu_torch.testing import dist as td
    a = td.collective_inputs(2, t=1024, k=512, out=1024,
                             ffn=(2, 512, 1024, 2752), vocab=4096,
                             emb_h=1024)
    np.savez(tmp_path / "inputs.npz", **a)
    job = {"inputs": str(tmp_path / "inputs.npz"), "device": "cuda",
           "dtype": "bfloat16"}
    reports = td.spawn(td.collective_job, 2, (job,), timeout=300,
                       store_dir=str(tmp_path))
    for r in reports:
        cases = r["cases"]
        np.testing.assert_array_equal(cases["hop"]["out"],
                                      cases["hop"]["want"])
        for name in ("rar", "rag", "rr", "rg", "ffn", "embed"):
            tags = ("", ":chunks4") if name in ("rar", "rag", "rr",
                                                "rg") else ("",)
            for tag in tags:
                ring, blk = cases[f"{name}:ring{tag}"], \
                    cases[f"{name}:blocking"]
                assert ring.keys() == blk.keys()
                for k in ring:
                    np.testing.assert_array_equal(ring[k], blk[k],
                                                  err_msg=(name, tag, k))


def test_tp_serving_on_card_matches_mp1(dev, tmp_path):
    """Two ranks on the card joined over gloo serve a tiny fp32 Llama at
    mp 2 through the card kernels (plain, and int8 KV with the prefix
    cache and speculation on): every rank's streams equal the mp 1
    engine's on the card, its event log rank 0's, its pool leak-free."""
    from paddle_tpu_torch.inference import (InferenceEngine, Request,
                                            ServeConfig)
    from paddle_tpu_torch.testing import dist as td
    cfg = tl.llama_tiny(vocab=96, hidden=256, layers=2, heads=4, kv_heads=2,
                        seq=512)
    params = tl.init_llama_params(cfg, seed=3, device="cpu")
    np.savez(tmp_path / "w.npz", **td.flat_tree(params))
    rng = np.random.RandomState(0)
    trace = [dict(prompt=rng.randint(1, 96, size=n).tolist(),
                  max_new_tokens=8, arrival=float(i), request_id=i)
             for i, n in enumerate((7, 130, 300))]
    serve = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=64, max_seq_len=512)
    runs = {"plain": {}, "int8-spec": dict(kv_dtype="int8",
                                           prefix_cache=True,
                                           speculative=True, draft_k=3)}
    want = {}
    card = tl._tree_map(lambda t: t.to(dev), params)
    for name, kw in runs.items():
        eng = InferenceEngine(card, cfg, ServeConfig(**serve, **kw),
                              record_events=True, device=dev)
        eng.run([Request(**r) for r in trace], deterministic=True)
        want[name] = {s.req.request_id: list(s.generated)
                      for s in eng.finished}
    fields = {f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "max_position_embeddings")}
    job = {"config": dict(fields, dtype="float32"),
           "weights": str(tmp_path / "w.npz"), "device": "cuda",
           "cases": [dict(name=n, kind="run", serve=dict(serve, mp=2, **kw),
                          trace=trace) for n, kw in runs.items()]}
    reports = td.spawn(td.serve_tp_job, 2, (job,), timeout=300,
                       store_dir=str(tmp_path))
    for name in runs:
        per = [r["cases"][name] for r in reports]
        for r in per:
            assert r["streams"] == want[name], name
            assert r["events"] == per[0]["events"], name
            assert r["used_blocks"] == 0 and r["stats"]["mp"] == 2


# the entries of rows 2-9 (and the diagnostics) that the wrappers of
# ops.paged_attention and chip_smoke load from the one library
PAGED_SYMBOLS = (
    "paged_attend_update_fwd", "paged_attention_fwd",
    "paged_attention_verify_fwd", "paged_verify_commit_fwd",
    "paged_attend_update_quant_fwd", "paged_attention_quant_fwd",
    "paged_attention_verify_quant_fwd", "paged_verify_commit_quant_fwd",
    "paged_quant_occupancy", "paged_attention_error_string")
# paged_quant_occupancy at HD 128, bs 128 from the library built whole,
# before csrc/paged_attention.cu was built in parts (chip_smoke's build
# phase, NVIDIA H100 80GB HBM3, 700.00 W): kind 0 the int8 decode walk at
# REP 1/2/4/8, kind 1 the int8 verify read in chunks of 2/4/5/8 rows
QUANT_OCCUPANCY = {0: ((1, 2, 4, 8), [6, 4, 4, 4]),
                   1: ((2, 4, 5, 8), [4, 4, 4, 2])}


def test_paged_parts_link_into_one_library(dev):
    """csrc/paged_attention.cu builds as several translation units linked
    into one library: every entry of rows 2-9 resolves in it, the int8
    walks' occupancy (its kernels in two parts, its entry in a third) is
    what the whole build gave, a bad argument still gives -1, and the
    error string export names a CUDA error."""
    import ctypes
    from paddle_tpu_torch import _build
    assert len(_build.PARTS["paged_attention"]) > 1
    lib = _build.load("paged_attention")
    for name in PAGED_SYMBOLS:
        assert getattr(lib, name) is not None, name
    occ = _build.kernel("paged_attention", "paged_quant_occupancy",
                        [ctypes.c_int] * 4)
    for kind, (rows, want) in QUANT_OCCUPANCY.items():
        assert [occ(kind, r, 128, 128) for r in rows] == want, kind
    assert occ(0, 5, 128, 128) == -1 and occ(1, 1, 128, 128) == -1
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.check("paged_attention", 1, "probe")
    for part in _build.PARTS["paged_attention"]:
        if f"paged_attention.{part}" in _build.BUILD_SECONDS:
            assert _build.BUILD_SECONDS[f"paged_attention.{part}"] > 0
