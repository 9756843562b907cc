"""Port parity: paddle_tpu_torch/ops against paddle_tpu/ops.

The same numpy inputs (seeded) go through the JAX function, run as its
own tests run it (Pallas in interpret mode on the CPU), and through the
port's CPU path, which is each kernel's plain PyTorch version. The CUDA
kernels themselves run only on the card: tests/test_torch_cuda.py and
``python3 chip_smoke.py`` hold them against the plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import _common
from paddle_tpu.ops import paged_attention as jax_pa
from paddle_tpu.ops.rms_norm import fused_rms_norm as jax_rms_norm
from paddle_tpu.ops.rope import apply_rope as jax_apply_rope
from paddle_tpu.ops.rope import build_rope_cache as jax_build_rope_cache

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.rms_norm import fused_rms_norm, rms_norm_plain
from paddle_tpu_torch.ops.rope import apply_rope, build_rope_cache

# llama_tiny geometry: GQA 4 query / 2 kv heads, head_dim 16; bs 128 is
# the JAX kernel's lane width
NH, NKV, HD, BS, L, NP = 4, 2, 16, 128, 2, 10
KVD = NKV * HD


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.mark.parametrize("shape", [(8, 64), (2, 3, 256)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


# The plain version (the card's oracle) to JAX's fused_rms_norm
# (interpret mode, jitted) at the card checks' grid: a decode step's 1 and
# 8 rows, a prefill chunk, a train step; ERNIE, TinyLlama, Llama and
# llama_13b widths; f32 within rtol 1e-6 (the means sum in another order),
# bf16 within one bf16 step (rtol 2^-7, as chip_smoke's RMS_TOL)
_jax_rms = jax.jit(jax_rms_norm, static_argnums=2)
RMS_CPU_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
               torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}


def _rms_against_jax(n, h, dtype, eps, zero_row=False):
    rng = np.random.default_rng(n + h)
    x = rng.standard_normal((n, h), dtype=np.float32)
    if zero_row:
        x[n // 2] = 0
    w = 1 + 0.1 * rng.standard_normal(h, dtype=np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(_jax_rms(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                              eps).astype(jnp.float32))
    got = rms_norm_plain(torch.from_numpy(x).to(dtype),
                         torch.from_numpy(w).to(dtype), eps)
    torch.testing.assert_close(got.float(), torch.from_numpy(ref.copy()),
                               **RMS_CPU_TOL[dtype])
    if zero_row:
        assert bool((got[n // 2] == 0).all())


@pytest.mark.parametrize("h", [1024, 2048, 4096, 5120])
@pytest.mark.parametrize("n", [1, 8, 256, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_plain_matches_jax_on_the_card_grid(dtype, n, h):
    _rms_against_jax(n, h, dtype, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_plain_matches_jax_odd_eps_and_zero_row(dtype):
    _rms_against_jax(256, 4096, dtype, 0.37)
    _rms_against_jax(8, 5120, dtype, 1e-6, zero_row=True)


def test_rms_norm_cpu_tensor_takes_plain_path_uncounted():
    x, w = torch.randn(4, 32), torch.randn(32)
    before = fused_rms_norm.launches
    assert torch.equal(fused_rms_norm(x, w), rms_norm_plain(x, w))
    assert fused_rms_norm.launches == before


def test_rope_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 1, NH, HD).astype(np.float32)
    positions = np.asarray([[0], [7], [300]], np.int32)
    jc, js = jax_build_rope_cache(3, HD, position_ids=jnp.asarray(positions))
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jc, js))
    c, s = build_rope_cache(3, HD, position_ids=torch.from_numpy(positions))
    got = apply_rope(torch.from_numpy(x), c, s)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def _paged_case(seed=0):
    """Ragged positions, a fragmented table, a fresh-block straddle
    (position 128 opens the row's second block) and a padding row (null
    table, position 0)."""
    rng = np.random.RandomState(seed)
    positions = np.asarray([5, 128, 0, 300, 127], np.int32)
    tables = np.asarray([[7, 0, 0],
                         [3, 9, 0],
                         [0, 0, 0],        # padding row -> null block 0
                         [8, 1, 5],
                         [2, 0, 0]], np.int32)
    B = len(positions)
    q = (rng.randn(B, NH, HD) * 0.5).astype(np.float32)
    new_k = rng.randn(B, KVD).astype(np.float32)
    new_v = rng.randn(B, KVD).astype(np.float32)
    k_pool = rng.randn(L, NP, KVD, BS).astype(np.float32)
    v_pool = rng.randn(L, NP, KVD, BS).astype(np.float32)
    qs = (q * np.float32(jax_pa._LOG2E / HD ** 0.5)).astype(np.float32)
    return qs, new_k, new_v, k_pool, v_pool, tables, positions


def _jax_paged(qs, new_k, new_v, k_pool, v_pool, tables, positions, layer):
    B = qs.shape[0]
    rep = NH // NKV
    eye = jnp.eye(NKV, dtype=jnp.float32)
    q_bd = jnp.einsum("bgrd,ge->bgred",
                      jnp.asarray(qs).reshape(B, NKV, rep, HD),
                      eye).reshape(B, NH, KVD)
    out, kp, vp = jax_pa.paged_attend_update(
        q_bd, jnp.asarray(new_k), jnp.asarray(new_v), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(tables), jnp.asarray(positions),
        layer)
    attn = jnp.einsum("bgred,ge->bgrd", out.reshape(B, NKV, rep, NKV, HD),
                      eye).reshape(B, NH, HD)
    return np.asarray(attn), np.asarray(kp), np.asarray(vp)


@pytest.mark.parametrize("mode", ["auto", "online"])
def test_paged_attend_update_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    case = _paged_case()
    ref_attn, ref_k, ref_v = _jax_paged(*case, layer=1)
    qs, new_k, new_v, k_pool, v_pool, tables, positions = case
    kp, vp = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    attn = pa.paged_attend_update(
        torch.from_numpy(qs), torch.from_numpy(new_k),
        torch.from_numpy(new_v), kp, vp, torch.from_numpy(tables),
        torch.from_numpy(positions), 1)
    live = positions != 0
    np.testing.assert_allclose(attn.numpy()[live], ref_attn[live], atol=1e-5)
    # block 0 is the null block padding rows scribble on; every other
    # block, written columns included, is bitwise the JAX pools
    np.testing.assert_array_equal(kp.numpy()[:, 1:], ref_k[:, 1:])
    np.testing.assert_array_equal(vp.numpy()[:, 1:], ref_v[:, 1:])
    for b in np.nonzero(live)[0]:
        blk, col = tables[b, positions[b] // BS], positions[b] % BS
        np.testing.assert_array_equal(kp.numpy()[1, blk, :, col], new_k[b])


def test_paged_attend_update_position_zero_row_attends_itself():
    """A live row at position 0 sees exactly one token: its own new v."""
    qs, new_k, new_v, k_pool, v_pool, tables, positions = _paged_case(1)
    positions[:] = 0
    tables[:, 0] = np.arange(1, len(positions) + 1)
    attn = pa.paged_attend_update(
        torch.from_numpy(qs), torch.from_numpy(new_k),
        torch.from_numpy(new_v), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.from_numpy(positions), 0)
    want = np.repeat(new_v.reshape(-1, NKV, 1, HD), NH // NKV, axis=2)
    np.testing.assert_allclose(attn.numpy(), want.reshape(-1, NH, HD),
                               atol=1e-6)


def test_paged_attend_update_rejects_bad_inputs():
    qs, new_k, new_v, k_pool, v_pool, tables, positions = _paged_case()
    args = [torch.from_numpy(a) for a in
            (qs, new_k, new_v, k_pool, v_pool, tables, positions)]
    with pytest.raises(TypeError):
        pa.paged_attend_update(*args[:5], args[5].long(), args[6], 0)
    with pytest.raises(ValueError):
        pa.paged_attend_update(*args, 2)                    # layer >= L
    with pytest.raises(TypeError):
        pa.paged_attend_update(args[0].double(), *args[1:], 0)


def _jax_paged_read(qs, k_pool, v_pool, tables, lengths, layer, dtype):
    """JAX's read-only paged_attention (row 2) with per-head q carried to
    its block-diagonal [B, NH, KVD] layout and back."""
    B = qs.shape[0]
    rep = NH // NKV
    eye = jnp.eye(NKV, dtype=jnp.float32)
    q_bd = jnp.einsum("bgrd,ge->bgred",
                      jnp.asarray(qs).reshape(B, NKV, rep, HD),
                      eye).reshape(B, NH, KVD)
    out = jax_pa.paged_attention(
        q_bd.astype(dtype), jnp.asarray(k_pool).astype(dtype),
        jnp.asarray(v_pool).astype(dtype), jnp.asarray(tables),
        jnp.asarray(lengths), layer)
    attn = jnp.einsum("bgred,ge->bgrd", out.reshape(B, NKV, rep, NKV, HD),
                      eye).reshape(B, NH, HD)
    return np.asarray(attn)


# (dtype, atol): f32 sums in another order; bf16 rounds P at the same
# points (against another base in JAX's default fixed-base mode) and the
# two sums in another order, so a result may land a bf16 step apart
@pytest.mark.parametrize("mode", ["auto", "online"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_paged_attention_matches_jax(monkeypatch, mode, dtype, atol):
    """Row 2: ragged lengths over a fragmented table (two blocks out of
    order, a block edge at 128), a one-token row and a length-0 row, which
    JAX leaves unwritten and the port sets to 0."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    qs, _, _, k_pool, v_pool, tables, _ = _paged_case(3)
    lengths = np.asarray([6, 129, 0, 301, 1], np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_t = lambda a: torch.from_numpy(a).to(dtype)
    # both sides see the same (rounded) values
    qs, k_pool, v_pool = (to_t(a).float().numpy() for a in (qs, k_pool,
                                                            v_pool))
    ref = _jax_paged_read(qs, k_pool, v_pool, tables, lengths, 1, jdt)
    kp, vp = to_t(k_pool), to_t(v_pool)
    attn = pa.paged_attention(to_t(qs), kp, vp, torch.from_numpy(tables),
                              torch.from_numpy(lengths), 1)
    live = lengths > 0
    np.testing.assert_allclose(attn.numpy()[live], ref[live], atol=atol,
                               rtol=0)
    assert not attn.numpy()[~live].any()
    # nothing is written
    assert torch.equal(kp, to_t(k_pool)) and torch.equal(vp, to_t(v_pool))


def test_paged_attention_rejects_bad_inputs_and_leaves_counts():
    qs, _, _, k_pool, v_pool, tables, positions = _paged_case()
    args = [torch.from_numpy(a) for a in (qs, k_pool, v_pool, tables)]
    lengths = torch.from_numpy(positions + 1)
    before = pa.paged_attention.launches
    pa.paged_attention(*args, lengths, 0)
    assert pa.paged_attention.launches == before
    with pytest.raises(TypeError):
        pa.paged_attention(*args[:3], args[3].long(), lengths, 0)
    with pytest.raises(TypeError):
        pa.paged_attention(args[0].double(), *args[1:], lengths, 0)
    with pytest.raises(ValueError):
        pa.paged_attention(*args, lengths, 2)                # layer >= L
    with pytest.raises(ValueError):
        pa.paged_attention(*args, lengths[:3], 0)            # lengths [B]


# The kernel's split-context form of rows 3 and 2 (``splits`` > 1): a row's
# blocks are cut into runs of ``split_blocks(max_nb, splits)``, each run
# starts its recurrence from the max of all scores before it (so P is
# rounded against the same running max as one walk), and the row's live
# runs are combined in run order. Only that f32 combine differs from one
# walk: 1e-5 against JAX in f32. 12 splits of a 12-block table leave one
# block per split (the kernel's layout at the serving shape).
PAGED_SPLITS = (1, 2, 3, 12)
SPLIT_NB, SPLIT_NP = 12, 40
SPLIT_POSITIONS = np.asarray([5, 127, 128, 0, 700, 1535], np.int32)


def _split_case(seed=4, spread=None):
    """Rows over 12-block tables: a block edge (127, 128), a padding row
    (null table, position 0), a row across all 12 blocks. With
    ``spread``, the last row's blocks from slot 6 on have their keys
    scaled so that their scores lead by hundreds of log2 units."""
    rng = np.random.RandomState(seed)
    B = len(SPLIT_POSITIONS)
    need = SPLIT_POSITIONS // BS + 1
    perm = rng.permutation(np.arange(1, SPLIT_NP))
    tables = np.zeros((B, SPLIT_NB), np.int32)
    at = 0
    for b in range(B):
        if b == 3:
            continue                     # padding row -> null block 0
        tables[b, :need[b]] = perm[at:at + need[b]]
        at += need[b]
    q = (rng.randn(B, NH, HD) * 0.5).astype(np.float32)
    new_k = rng.randn(B, KVD).astype(np.float32)
    new_v = rng.randn(B, KVD).astype(np.float32)
    k_pool = rng.randn(L, SPLIT_NP, KVD, BS).astype(np.float32)
    v_pool = rng.randn(L, SPLIT_NP, KVD, BS).astype(np.float32)
    if spread is not None:
        k_pool[:, tables[-1, 6:]] *= spread
    qs = (q * np.float32(jax_pa._LOG2E / HD ** 0.5)).astype(np.float32)
    return qs, new_k, new_v, k_pool, v_pool, tables, SPLIT_POSITIONS.copy()


def _score_lead(qs, k_pool, tables, layer=1):
    """How far the last row's slots 6.. lead slots 0..5, in log2 units."""
    kt = k_pool[layer, tables[-1]].reshape(SPLIT_NB, NKV, HD, BS)
    qg = qs[-1].reshape(NKV, NH // NKV, HD)
    s = np.einsum("grd,jgdt->jgrt", qg, kt)
    return s[6:].max() - s[:6].max()


_JAX_SPLIT_REFS = {}


def _jax_split_refs(mode, spread):
    """JAX's update (attn, pools) and read-only outputs on
    :func:`_split_case`, once per softmax mode and spread."""
    key = (mode, spread)
    if key not in _JAX_SPLIT_REFS:
        case = _split_case(spread=spread)
        qs, _, _, k_pool, v_pool, tables, positions = case
        upd = _jax_paged(*case, layer=1)
        read = _jax_paged_read(qs, k_pool, v_pool, tables, positions + 1, 1,
                               jnp.float32)
        _JAX_SPLIT_REFS[key] = upd, read
    return _JAX_SPLIT_REFS[key]


def _check_split_plain(mode, splits, spread=None):
    case = _split_case(spread=spread)
    (ref_attn, ref_k, ref_v), ref_read = _jax_split_refs(mode, spread)
    qs, new_k, new_v, k_pool, v_pool, tables, positions = case
    t = torch.from_numpy
    kp, vp = t(k_pool.copy()), t(v_pool.copy())
    attn = pa.paged_attend_update_plain(
        t(qs), t(new_k), t(new_v), kp, vp, t(tables), t(positions), 1,
        splits=splits)
    read = pa.paged_attention_plain(t(qs), t(k_pool), t(v_pool), t(tables),
                                    t(positions + 1), 1, splits=splits)
    live = tables[:, 0] != 0
    np.testing.assert_allclose(attn.numpy()[live], ref_attn[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(read.numpy()[live], ref_read[live], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(kp.numpy()[:, 1:], ref_k[:, 1:])
    np.testing.assert_array_equal(vp.numpy()[:, 1:], ref_v[:, 1:])


@pytest.mark.parametrize("splits", PAGED_SPLITS)
@pytest.mark.parametrize("mode", ["auto", "online"])
def test_paged_split_plain_matches_jax(monkeypatch, mode, splits):
    """Rows 3 and 2's plain versions at ``splits`` against JAX."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    _check_split_plain(mode, splits)


@pytest.mark.parametrize("splits", PAGED_SPLITS)
def test_paged_split_plain_holds_a_score_spread(monkeypatch, splits):
    """The last row's blocks from slot 6 on lead the earlier ones by
    hundreds of log2 units, across split boundaries (online softmax: JAX's
    tile-0-anchored default overflows there)."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", "online")
    qs, _, _, k_pool, _, tables, _ = _split_case(spread=150.0)
    assert _score_lead(qs, k_pool, tables) > 200
    _check_split_plain("online", splits, spread=150.0)


@pytest.mark.parametrize("splits", PAGED_SPLITS)
def test_paged_split_plain_bf16_matches_jax(monkeypatch, splits):
    """Row 2 in bf16 at ``splits``: JAX rounds P at the same points; the
    sums run in another order, so a result may land a bf16 step apart."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", "online")
    qs, _, _, k_pool, v_pool, tables, positions = _split_case(5)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qs, k_pool, v_pool = (bf(a).float().numpy() for a in (qs, k_pool, v_pool))
    lengths = positions + 1
    ref = _jax_paged_read(qs, k_pool, v_pool, tables, lengths, 1,
                          jnp.bfloat16)
    got = pa.paged_attention_plain(bf(qs), bf(k_pool), bf(v_pool),
                                   torch.from_numpy(tables),
                                   torch.from_numpy(lengths), 1,
                                   splits=splits)
    live = tables[:, 0] != 0
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=2.0 ** -7,
                               rtol=0)


def _attend_plain_before_splits(q, k_pool, v_pool, tables, last, layer):
    """The plain walk as it was before the ``splits`` keyword, kept
    verbatim as the reference of the bitwise test below."""
    B, NH_, HD_ = q.shape
    bs = k_pool.shape[-1]
    nkv = k_pool.shape[2] // HD_
    rep = NH_ // nkv
    qf = q.float().reshape(B, nkv, rep, HD_)
    m = torch.full((B, nkv, rep), float("-inf"), device=q.device)
    l = torch.zeros((B, nkv, rep), device=q.device)
    acc = torch.zeros((B, nkv, rep, HD_), device=q.device)
    col = torch.arange(bs, device=q.device)
    for j in range(int(last.max()) // bs + 1):
        blk = tables[:, j].long()
        kt = k_pool[layer, blk].float().reshape(B, nkv, HD_, bs)
        vt = v_pool[layer, blk].float().reshape(B, nkv, HD_, bs)
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = (j * bs + col)[None, :] <= last[:, None]
        s = torch.where(live[:, None, None, :], s,
                        torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrt,bgdt->bgrd", p.to(v_pool.dtype).float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, NH_, HD_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_plain_one_split_is_the_walk_before_splits(dtype):
    qs, _, _, k_pool, v_pool, tables, positions = _split_case(6)
    q, kp, vp = (torch.from_numpy(a).to(dtype) for a in (qs, k_pool, v_pool))
    tb, lengths = torch.from_numpy(tables), torch.from_numpy(positions + 1)
    want = _attend_plain_before_splits(q, kp, vp, tb, lengths.long() - 1, 1)
    want = torch.where((lengths > 0)[:, None, None], want, 0.0)
    for got in (pa.paged_attention_plain(q, kp, vp, tb, lengths, 1),
                pa.paged_attention_plain(q, kp, vp, tb, lengths, 1,
                                         splits=1)):
        assert torch.equal(got, want)


def test_paged_kernel_splits_follow_the_shapes():
    """One block per split at bs = 128 (SPLIT_TOKENS), at least one block
    at larger bs, and never more than MAX_SPLITS runs; the plain version's
    runs at that split count are the kernel's."""
    assert pa.kernel_splits(16, 128) == 16
    assert pa.kernel_splits(16, 256) == 16
    assert pa.kernel_splits(1, 1024) == 1
    for max_nb in (1, 7, 255, 256, 257, 2000):
        n = pa.kernel_splits(max_nb, 128)
        assert 1 <= n <= pa.MAX_SPLITS
        assert pa.split_blocks(max_nb, n) * n >= max_nb
        assert pa.split_blocks(max_nb, n) * (n - 1) < max_nb
