"""Port parity: int8 paged KV in paddle_tpu_torch against paddle_tpu.

The same numpy-seeded inputs and weights go through the JAX functions
(Pallas in interpret mode on the CPU, as tests/test_kv_int8.py runs them;
the model steps through their jitted ``_quant`` forms, as the JAX engine
calls them) and through the port's CPU path, where rows 4, 5, 7 and 9 run
their plain PyTorch versions. Held here:
  - ``kv_quant_columns`` bitwise to ``jax.jit(kv_quant_columns)`` on f32
    and bf16 input, the all-zero column floored; and the one-ulp gap to
    the eager JAX call, pinned (XLA computes absmax / 127 as absmax *
    f32(1/127) under jit, where every pool byte of the JAX engine is
    written);
  - the plain versions of rows 5 (``paged_attend_update_quant``), 4
    (``paged_attention_quant``) and 7 (``paged_attention_verify_quant``)
    against JAX's kernels in both softmax modes, after JAX's head
    selection, in one walk and in the kernels' split form (``splits``):
    f32 to 2e-5, as tests/test_kv_int8.py holds the kernels to XLA (P is
    f32 in both; the anchors and sums differ in f32 rounding); row 5's
    written bytes and scales bitwise; live rows only for row 4 (JAX leaves
    a length-0 row unwritten, the port writes 0); row 7's padding row gets
    the defined partials; ``splits=1`` bitwise the walk before splits;
  - row 9's plain version (``paged_verify_commit_quant``) bitwise, block 0
    aside (rejected columns land there in no set order);
  - the int8 decode step, prefill chunk and verify step against JAX's
    jitted ``_quant`` steps: greedy tokens, commit lengths and fin_ok
    equal; every pool entry not written bitwise unchanged; written scales
    to 2e-6 relative; written codes within one step (the k and v columns
    come from matmuls that XLA and torch sum in another order, so a value
    on a rounding boundary may round the other way: a handful of the
    written codes at most, counted in the failure message; none of the
    3,072 codes these three cases write differs here);
  - path independence: a prefill chunk and a decode step write the same
    bytes and scales for the same token at the same position;
  - the engine with ``kv_dtype="int8"``: streams and events equal JAX's
    int8 engine on tests/test_kv_int8.py's trace and, with speculation, on
    tests/test_torch_spec.py's ``basic`` trace (and equal the port's
    non-speculative int8 streams); a replay is deterministic; an unknown
    ``kv_dtype`` raises; ``"auto"`` keeps the model-dtype pools, no scale
    pools and the default's streams.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import InferenceEngine as JaxEngine
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServeConfig as JaxServeConfig
from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common
from paddle_tpu.ops import paged_attention as jpa

from paddle_tpu_torch.inference import InferenceEngine, Request, ServeConfig
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.ops import paged_attention as pa

BS = 128
KERNEL_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the quantizer ------------------------------------------------------------

_jax_quant = jax.jit(jpa.kv_quant_columns, static_argnums=1)


def _columns(seed, n=256, kvd=128):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, kvd) * rng.choice([0.01, 1.0, 40.0], size=(n, 1))) \
        .astype(np.float32)
    x[3] = 0.0                      # an all-zero column: the scale floor
    return x


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kv_quant_columns_bitwise_to_jit(dtype):
    x = jnp.asarray(_columns(0)).astype(dtype)
    want_q, want_s = _jax_quant(x, 4)
    xt = _t(x.astype(jnp.float32))
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    q, s = pa.kv_quant_columns(xt, 4)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert (q[3] == 0).all()
    assert (s[3] == np.float32(pa.KV_SCALE_FLOOR)).all()
    assert int(q.abs().max()) <= pa.KV_QMAX


def test_kv_quant_columns_eager_gap_pinned():
    """The eager JAX call divides absmax by 127; the jitted one (and the
    port) multiplies by f32(1/127). They differ by one ulp in some scales,
    and a division in torch reproduces the eager call bitwise."""
    x = _columns(1)
    eager_q, eager_s = (np.asarray(a) for a in
                        jpa.kv_quant_columns(jnp.asarray(x), 4))
    q, s = pa.kv_quant_columns(torch.from_numpy(x), 4)
    s = s.numpy()
    gap = s != eager_s
    assert gap.any()
    np.testing.assert_array_equal(
        np.abs(s[gap].view(np.int32) - eager_s[gap].view(np.int32)), 1)
    absmax = torch.from_numpy(x).reshape(-1, 4, 32).abs().amax(-1)
    div = torch.clamp(absmax / pa.KV_QMAX, min=pa.KV_SCALE_FLOOR)
    np.testing.assert_array_equal(div.numpy(), eager_s)
    # codes follow their scales: at most one step apart where they differ
    assert np.abs(q.numpy().astype(int) - eager_q.astype(int)).max() <= 1


# -- rows 5, 4 and 7: the attention reads -------------------------------------

NKV, HD = 2, 32
KVD = NKV * HD


def _quant_pool(rng, n_pool, layers=2):
    """Int8 pools with their scales from random fp columns, through the
    port's quantizer (bitwise JAX's jitted one)."""
    cols = torch.from_numpy((rng.randn(layers * n_pool * BS, KVD) * 2)
                            .astype(np.float32))
    q, s = pa.kv_quant_columns(cols, NKV)
    qp = q.reshape(layers, n_pool, BS, KVD).permute(0, 1, 3, 2).contiguous()
    sp = s.reshape(layers, n_pool, BS, NKV).permute(0, 1, 3, 2).contiguous()
    return qp.numpy(), sp.numpy()


def _tables(rng, counts, max_nb):
    """Distinct random pool blocks (never block 0) for each row's count of
    tokens; returns (tables, pool size)."""
    need = [-(-c // BS) for c in counts]
    perm = iter(rng.permutation(np.arange(1, 1 + sum(need))))
    tables = np.zeros((len(counts), max_nb), np.int32)
    for i, n in enumerate(need):
        for j in range(n):
            tables[i, j] = next(perm)
    return tables, 1 + sum(need)


def _q_bd(q, dtype=jnp.float32):
    """Per-head q [..., NH, HD] -> JAX's block-diagonal rows [.., NH, KVD]."""
    *lead, nh, hd = q.shape
    rep = nh // NKV
    qg = jnp.asarray(q, dtype).reshape(*lead, NKV, rep, hd)
    eye = jnp.eye(NKV, dtype=dtype)
    return jnp.einsum("...grd,ge->...gred", qg, eye).reshape(*lead, nh,
                                                             NKV * hd)


def _heads(out_bd):
    """JAX's head selection: [..., NH, KVD] -> [..., NH, HD]."""
    *lead, nh, kvd = out_bd.shape
    rep = nh // NKV
    out = np.asarray(out_bd).reshape(*lead, NKV, rep, NKV, HD)
    return np.einsum("...gred,ge->...grd", out, np.eye(NKV)).reshape(
        *lead, nh, HD)


POSITIONS = [0, 5, 127, 128, 300]      # 128 opens a fresh block


def _decode_case(rep, seed):
    rng = np.random.RandomState(seed)
    tables, n_pool = _tables(rng, [p + 1 for p in POSITIONS], 3)
    kq, ks = _quant_pool(rng, n_pool)
    vq, vs = _quant_pool(rng, n_pool)
    q = (rng.randn(len(POSITIONS), NKV * rep, HD)
         * (jpa._LOG2E / HD ** 0.5)).astype(np.float32)
    nk, nks = pa.kv_quant_columns(torch.from_numpy(
        rng.randn(len(POSITIONS), KVD).astype(np.float32)), NKV)
    nv, nvs = pa.kv_quant_columns(torch.from_numpy(
        rng.randn(len(POSITIONS), KVD).astype(np.float32)), NKV)
    return q, tables, (kq, vq, ks, vs), [a.numpy() for a in (nk, nv, nks,
                                                              nvs)]


@pytest.mark.parametrize("mode", ["auto", "online"])
@pytest.mark.parametrize("rep", [1, 4])
def test_update_quant_plain_matches_jax(monkeypatch, mode, rep):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, tables, pools, new = _decode_case(rep, seed=rep)
    pos = np.asarray(POSITIONS, np.int32)
    jout, *jpools = jpa.paged_attend_update_quant(
        _q_bd(q), *(jnp.asarray(a) for a in new),
        *(jnp.asarray(a) for a in pools), jnp.asarray(tables),
        jnp.asarray(pos), 1)
    tpools = [_t(a) for a in pools]
    out = pa.paged_attend_update_quant(_t(q), *(_t(a) for a in new),
                                       *tpools, _t(tables), _t(pos), 1)
    np.testing.assert_allclose(out.numpy(), _heads(jout), atol=KERNEL_ATOL,
                               rtol=KERNEL_ATOL)
    # every pool, the written columns included, bitwise JAX's
    for got, want in zip(tpools, jpools):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    blk = tables[np.arange(len(pos)), pos // BS]
    np.testing.assert_array_equal(tpools[0].numpy()[1, blk, :, pos % BS],
                                  new[0])
    np.testing.assert_array_equal(tpools[2].numpy()[1, blk, :, pos % BS],
                                  new[2])


@pytest.mark.parametrize("mode", ["auto", "online"])
def test_attention_quant_plain_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, tables, pools, _ = _decode_case(2, seed=7)
    lengths = np.asarray([0, 1, 128, 129, 300], np.int32)
    want = _heads(jpa.paged_attention_quant(
        _q_bd(q), *(jnp.asarray(a) for a in pools), jnp.asarray(tables),
        jnp.asarray(lengths), 1))
    out = pa.paged_attention_quant(_t(q), *(_t(a) for a in pools),
                                   _t(tables), _t(lengths), 1).numpy()
    live = lengths > 0
    np.testing.assert_allclose(out[live], want[live], atol=KERNEL_ATOL,
                               rtol=KERNEL_ATOL)
    assert (out[~live] == 0).all()
    # the write-free read of row 5's state is row 5's attention
    pos = lengths - 1
    pos[~live] = 0
    tp = [_t(a) for a in pools]
    ref = pa._attend_quant_plain(_t(q), *tp, _t(tables),
                                 _t(pos).long(), 1).numpy()
    np.testing.assert_array_equal(out[live], ref[live])


QSTART = [0, 1, 127, 129, 300]         # 0: padding row; 129 crosses a block


@pytest.mark.parametrize("mode", ["auto", "online"])
@pytest.mark.parametrize("rep,T", [(1, 1), (2, 3)])
def test_verify_quant_plain_matches_jax(monkeypatch, mode, rep, T):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    rng = np.random.RandomState(10 + T)
    tables, n_pool = _tables(rng, QSTART, 4)
    pools = _quant_pool(rng, n_pool) + _quant_pool(rng, n_pool)
    pools = (pools[0], pools[2], pools[1], pools[3])
    B, nh = len(QSTART), NKV * rep
    q = (rng.randn(B, T, nh, HD) * (jpa._LOG2E / HD ** 0.5)) \
        .astype(np.float32)
    qstart = np.asarray(QSTART, np.int32)
    acc, m, l = jpa.paged_attention_verify_quant(
        _q_bd(q).reshape(B, T * nh, KVD), *(jnp.asarray(a) for a in pools),
        jnp.asarray(tables), jnp.asarray(qstart), 1)
    acc = _heads(np.asarray(acc).reshape(B, T, nh, KVD))
    m = np.asarray(m)[..., 0].reshape(B, T, nh)
    l = np.asarray(l)[..., 0].reshape(B, T, nh)
    ga, gm, gl = pa.paged_attention_verify_quant(
        _t(q), *(_t(a) for a in pools), _t(tables), _t(qstart), 1)
    live = qstart > 0
    np.testing.assert_allclose((ga / gl[..., None]).numpy()[live],
                               (acc / l[..., None])[live],
                               atol=KERNEL_ATOL, rtol=KERNEL_ATOL)
    np.testing.assert_allclose((gm + torch.log2(gl)).numpy()[live],
                               (m + np.log2(l))[live], atol=1e-4, rtol=1e-6)
    dead = torch.from_numpy(~live)
    assert (ga[dead] == 0).all() and (gl[dead] == 0).all()
    assert (gm[dead] == -1e30).all()


# Row 7's plain version at the kernel's split form (``splits`` > 1; see
# tests/test_torch_spec.py's row 6 twin) against JAX, as above (f32 to
# KERNEL_ATOL, m + log2(l) to 1e-4 + 1e-6 |ref|), over rows of up to 6
# blocks at splits up to the table's width; with a score spread (the K
# scales of the last row's blocks from slot 3 on times 150, so its scores
# lead by hundreds of log2 units across split boundaries) in the online
# mode.
SPLIT_QSTART = [0, 1, 128, 129, 300, 700]
VERIFY_SPLITS = (1, 2, 3, 6)


def _verify_split_case(spread=None):
    rng = np.random.RandomState(22)
    tables, n_pool = _tables(rng, SPLIT_QSTART, 6)
    (kq, ks), (vq, vs) = _quant_pool(rng, n_pool), _quant_pool(rng, n_pool)
    if spread is not None:
        ks[:, tables[-1, 3:]] *= spread
    q = (rng.randn(len(SPLIT_QSTART), 3, NKV * 2, HD)
         * (jpa._LOG2E / HD ** 0.5)).astype(np.float32)
    return q, (kq, vq, ks, vs), tables, np.asarray(SPLIT_QSTART, np.int32)


_JAX_VERIFY_SPLIT = {}


def _jax_verify_quant(q, pools, tables, qstart):
    """JAX's int8 verify read after its head selection: acc / l per head
    [B, T, NH, HD] and m + log2(l) [B, T, NH]."""
    B, T, nh, _ = q.shape
    acc, m, l = jpa.paged_attention_verify_quant(
        _q_bd(q).reshape(B, T * nh, KVD), *(jnp.asarray(a) for a in pools),
        jnp.asarray(tables), jnp.asarray(qstart), 1)
    acc = _heads(np.asarray(acc).reshape(B, T, nh, KVD))
    m = np.asarray(m)[..., 0].reshape(B, T, nh)
    l = np.asarray(l)[..., 0].reshape(B, T, nh)
    return acc / l[..., None], m + np.log2(l)


def _check_verify_quant_split(monkeypatch, mode, splits, spread=None):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, pools, tables, qstart = _verify_split_case(spread)
    if (mode, spread) not in _JAX_VERIFY_SPLIT:
        _JAX_VERIFY_SPLIT[mode, spread] = _jax_verify_quant(q, pools, tables,
                                                            qstart)
    want_o, want_lse = _JAX_VERIFY_SPLIT[mode, spread]
    ga, gm, gl = pa.paged_attention_verify_quant_plain(
        _t(q), *(_t(a) for a in pools), _t(tables), _t(qstart), 1,
        splits=splits)
    live = qstart > 0
    np.testing.assert_allclose((ga / gl[..., None]).numpy()[live],
                               want_o[live], atol=KERNEL_ATOL,
                               rtol=KERNEL_ATOL)
    np.testing.assert_allclose((gm + torch.log2(gl)).numpy()[live],
                               want_lse[live], atol=1e-4, rtol=1e-6)
    dead = torch.from_numpy(~live)
    assert (ga[dead] == 0).all() and (gl[dead] == 0).all()
    assert (gm[dead] == -1e30).all()
    return want_lse


@pytest.mark.parametrize("splits", VERIFY_SPLITS)
@pytest.mark.parametrize("mode", ["auto", "online"])
def test_verify_quant_split_plain_matches_jax(monkeypatch, mode, splits):
    _check_verify_quant_split(monkeypatch, mode, splits)


@pytest.mark.parametrize("splits", VERIFY_SPLITS)
def test_verify_quant_split_plain_holds_a_score_spread(monkeypatch, splits):
    lse = _check_verify_quant_split(monkeypatch, "online", splits,
                                    spread=150.0)
    assert lse[-1].min() > 150      # the spread blocks' scores dominate


def _verify_quant_plain_before_splits(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, qstart, layer):
    """Row 7's plain version (and ``_quant_walk``) as they were before the
    ``splits`` keyword, kept verbatim as the reference of the bitwise test
    below."""
    B, T, NH, HD_ = q.shape
    nkv = k_scale.shape[2]
    rep = NH // nkv
    dev = q.device
    qf = q.float().reshape(B, T, nkv, rep, HD_).transpose(1, 2) \
        .reshape(B, nkv, T * rep, HD_)
    last = qstart.long() - 1
    R = T * rep
    bs = k_pool.shape[-1]
    m = torch.full((B, nkv, R), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, R), device=dev)
    acc = torch.zeros((B, nkv, R, HD_), device=dev)
    col = torch.arange(bs, device=dev)
    for j in range(int(last.max()) // bs + 1 if B else 0):
        blk = tables[:, j].long()
        kt = pa.kv_dequant_blocks(k_pool[layer, blk], k_scale[layer, blk])
        vt = pa.kv_dequant_blocks(v_pool[layer, blk], v_scale[layer, blk])
        kt = kt.reshape(B, nkv, HD_, bs)
        vt = vt.reshape(B, nkv, HD_, bs)
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = (j * bs + col)[None, :] <= last[:, None]
        s = torch.where(live[:, None, None, :], s,
                        torch.tensor(-1e30, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrt,bgdt->bgrd", p, vt)
        m = m_new
    dead = (qstart <= 0)[:, None, None]
    m = torch.where(dead, torch.tensor(-1e30, device=dev), m)
    l = torch.where(dead, torch.tensor(0.0, device=dev), l)
    acc = torch.where(dead[..., None], torch.tensor(0.0, device=dev), acc)
    acc = acc.reshape(B, nkv, T, rep, HD_).transpose(1, 2) \
        .reshape(B, T, NH, HD_)
    m = m.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, NH)
    l = l.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, NH)
    return acc, m, l


def test_verify_quant_plain_one_split_is_the_walk_before_splits():
    """``splits=1`` (and the default) is bitwise the walk before splits."""
    q, pools, tables, qstart = _verify_split_case()
    args = (_t(q), *(_t(a) for a in pools), _t(tables), _t(qstart), 1)
    want = _verify_quant_plain_before_splits(*args)
    for got in (pa.paged_attention_verify_quant_plain(*args),
                pa.paged_attention_verify_quant_plain(*args, splits=1)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


# Rows 5 and 4's plain versions at the kernel's split form (``splits`` > 1,
# each run from its own max, as the int8 kernels take no look-back) against
# JAX, as above (f32 to KERNEL_ATOL), over rows of up to 6 blocks at splits
# up to the table's width, REP 1 and 4; with a score spread (the K scales of
# the last row's blocks from slot 3 on times 150, so its scores lead by
# hundreds of log2 units across split boundaries) in the online mode.
DECODE_SPLIT_POSITIONS = [0, 127, 128, 300, 700]
DECODE_SPLIT_LENGTHS = [0, 1, 128, 129, 701]


def _decode_split_case(rep, spread=None):
    rng = np.random.RandomState(30 + rep)
    tables, n_pool = _tables(rng, [p + 1 for p in DECODE_SPLIT_POSITIONS], 6)
    (kq, ks), (vq, vs) = _quant_pool(rng, n_pool), _quant_pool(rng, n_pool)
    if spread is not None:
        ks[:, tables[-1, 3:]] *= spread
    q = (rng.randn(len(DECODE_SPLIT_POSITIONS), NKV * rep, HD)
         * (jpa._LOG2E / HD ** 0.5)).astype(np.float32)
    nk, nks = pa.kv_quant_columns(torch.from_numpy(
        rng.randn(len(DECODE_SPLIT_POSITIONS), KVD).astype(np.float32)), NKV)
    nv, nvs = pa.kv_quant_columns(torch.from_numpy(
        rng.randn(len(DECODE_SPLIT_POSITIONS), KVD).astype(np.float32)), NKV)
    return q, tables, (kq, vq, ks, vs), [a.numpy() for a in (nk, nv, nks,
                                                              nvs)]


_JAX_DECODE_SPLIT = {}


def _jax_decode_quant(kind, mode, rep, spread):
    """JAX's row 5 (attn after its head selection, and the pools it
    leaves) or row 4 (attn) on :func:`_decode_split_case`, jitted once a
    softmax mode (JAX reads the mode at trace time) and cached."""
    key = (kind, mode, rep, spread)
    if key not in _JAX_DECODE_SPLIT:
        q, tables, pools, new = _decode_split_case(rep, spread)
        if kind == "update":
            fn = jax.jit(lambda *a: jpa.paged_attend_update_quant(*a, 1))
            out, *jpools = fn(_q_bd(q), *(jnp.asarray(a) for a in new),
                              *(jnp.asarray(a) for a in pools),
                              jnp.asarray(tables),
                              jnp.asarray(DECODE_SPLIT_POSITIONS, jnp.int32))
            res = (_heads(out), [np.asarray(a) for a in jpools])
        else:
            fn = jax.jit(lambda *a: jpa.paged_attention_quant(*a, 1))
            res = (_heads(fn(_q_bd(q), *(jnp.asarray(a) for a in pools),
                             jnp.asarray(tables),
                             jnp.asarray(DECODE_SPLIT_LENGTHS, jnp.int32))),
                   None)
        _JAX_DECODE_SPLIT[key] = res
    return _JAX_DECODE_SPLIT[key]


def _check_update_quant_split(monkeypatch, mode, splits, rep, spread=None):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, tables, pools, new = _decode_split_case(rep, spread)
    want, want_pools = _jax_decode_quant("update", mode, rep, spread)
    tpools = [_t(a) for a in pools]
    out = pa.paged_attend_update_quant_plain(
        _t(q), *(_t(a) for a in new), *tpools, _t(tables),
        _t(np.asarray(DECODE_SPLIT_POSITIONS, np.int32)), 1, splits=splits)
    np.testing.assert_allclose(out.numpy(), want, atol=KERNEL_ATOL,
                               rtol=KERNEL_ATOL)
    for got, w in zip(tpools, want_pools):
        np.testing.assert_array_equal(got.numpy(), w)
    return q, tables, tpools


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("splits", VERIFY_SPLITS)
@pytest.mark.parametrize("mode", ["auto", "online"])
def test_update_quant_split_plain_matches_jax(monkeypatch, mode, splits, rep):
    _check_update_quant_split(monkeypatch, mode, splits, rep)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("splits", VERIFY_SPLITS)
@pytest.mark.parametrize("mode", ["auto", "online"])
def test_attention_quant_split_plain_matches_jax(monkeypatch, mode, splits,
                                                 rep):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, tables, pools, _ = _decode_split_case(rep)
    want, _ = _jax_decode_quant("read", mode, rep, None)
    lengths = np.asarray(DECODE_SPLIT_LENGTHS, np.int32)
    out = pa.paged_attention_quant_plain(
        _t(q), *(_t(a) for a in pools), _t(tables), _t(lengths), 1,
        splits=splits).numpy()
    live = lengths > 0
    np.testing.assert_allclose(out[live], want[live], atol=KERNEL_ATOL,
                               rtol=KERNEL_ATOL)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("splits", VERIFY_SPLITS)
def test_update_quant_split_plain_holds_a_score_spread(monkeypatch, splits):
    q, tables, pools = _check_update_quant_split(monkeypatch, "online",
                                                 splits, 4, spread=150.0)
    # the spread blocks' scores lead the row's first blocks by hundreds
    kt = pa.kv_dequant_blocks(pools[0][1, tables[-1]],
                              pools[2][1, tables[-1]]).reshape(6, NKV, HD, BS)
    s = torch.einsum("grd,jgdt->jgrt", _t(q)[-1].reshape(NKV, 4, HD), kt)
    assert (s[3:].amax() - s[:3].amax()).item() > 150


def _decode_quant_plain_before_splits(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, last, layer):
    """Rows 5 and 4's walk (``_attend_quant_plain``) as it was before the
    ``splits`` keyword, kept verbatim as the reference of the bitwise test
    below: attn [B, NH, HD] over tokens 0..last[b]."""
    B, NH, HD_ = q.shape
    nkv = k_scale.shape[2]
    R = NH // nkv
    dev = q.device
    qf = q.float().reshape(B, nkv, R, HD_)
    bs = k_pool.shape[-1]
    m = torch.full((B, nkv, R), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, R), device=dev)
    acc = torch.zeros((B, nkv, R, HD_), device=dev)
    col = torch.arange(bs, device=dev)
    for j in range(int(last.max()) // bs + 1 if B else 0):
        blk = tables[:, j].long()
        kt = pa.kv_dequant_blocks(k_pool[layer, blk], k_scale[layer, blk])
        vt = pa.kv_dequant_blocks(v_pool[layer, blk], v_scale[layer, blk])
        kt = kt.reshape(B, nkv, HD_, bs)
        vt = vt.reshape(B, nkv, HD_, bs)
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = (j * bs + col)[None, :] <= last[:, None]
        s = torch.where(live[:, None, None, :], s,
                        torch.tensor(-1e30, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrt,bgdt->bgrd", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, NH, HD_)


@pytest.mark.parametrize("rep", [1, 4])
def test_decode_quant_plain_one_split_is_the_walk_before_splits(rep):
    """``splits=1`` (and the default) of rows 5 and 4's plain versions is
    bitwise the walk before splits."""
    q, tables, pools, new = _decode_split_case(rep)
    pos = _t(np.asarray(DECODE_SPLIT_POSITIONS, np.int32))
    lengths = _t(np.asarray(DECODE_SPLIT_LENGTHS, np.int32))
    tp = [_t(a) for a in pools]
    want = _decode_quant_plain_before_splits(_t(q), *tp, _t(tables),
                                             lengths.long() - 1, 1)
    live = lengths > 0
    for kw in ({}, {"splits": 1}):
        got = pa.paged_attention_quant_plain(_t(q), *tp, _t(tables), lengths,
                                             1, **kw)
        assert torch.equal(got[live], want[live])
    for kw in ({}, {"splits": 1}):
        tpu = [t.clone() for t in tp]
        got = pa.paged_attend_update_quant_plain(
            _t(q), *(_t(a) for a in new), *tpu, _t(tables), pos, 1, **kw)
        want = _decode_quant_plain_before_splits(_t(q), *tpu, _t(tables),
                                                 pos.long(), 1)
        assert torch.equal(got, want)


# -- row 9: the commit --------------------------------------------------------

def test_commit_quant_plain_matches_jax_bitwise():
    rng = np.random.RandomState(5)
    L, T, n_pool = 2, 5, 12
    tables = np.asarray([[3, 4, 0], [0, 0, 0], [7, 0, 0], [9, 10, 11]],
                        np.int32)
    qstart = np.asarray([126, 0, 3, 254], np.int32)
    clen = np.asarray([5, 0, 2, 4], np.int32)
    kq, ks = _quant_pool(rng, n_pool, L)
    vq, vs = _quant_pool(rng, n_pool, L)
    cols = []
    for _ in range(2):
        c, s = pa.kv_quant_columns(torch.from_numpy(
            rng.randn(L * 4 * T, KVD).astype(np.float32)), NKV)
        cols += [c.reshape(L, 4, T, KVD).numpy(),
                 s.reshape(L, 4, T, NKV).numpy()]
    new = (cols[0], cols[2], cols[1], cols[3])
    want = jpa.paged_verify_commit_quant(
        *(jnp.asarray(a) for a in new + (kq, vq, ks, vs)),
        jnp.asarray(tables), jnp.asarray(qstart), jnp.asarray(clen))
    got = pa.paged_verify_commit_quant(
        *(_t(a) for a in new + (kq, vq, ks, vs)), _t(tables), _t(qstart),
        _t(clen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])
    # the accepted columns landed, the rejected one did not
    np.testing.assert_array_equal(got[0].numpy()[1, 4, :, 0], new[0][1, 0, 2])
    np.testing.assert_array_equal(got[2].numpy()[1, 4, :, 0], new[2][1, 0, 2])
    np.testing.assert_array_equal(got[0].numpy()[0, 7, :, 5], kq[0, 7, :, 5])


# Row 9's plain version (the card's oracle) to JAX's int8 commit
# (interpret mode, jitted) at the card checks' cases: commit lengths all
# 0, all 1, all T and mixed; windows across a block edge (qstart bs - 3,
# bs - 2); block sizes 16 to 1024; row 0 a padding row
COMMIT_LENS = {"none": [0] * 6, "one": [1] * 6, "all": [5] * 6,
               "mixed": [0, 5, 3, 5, 1, 4]}
_jax_commit_quant = jax.jit(jpa.paged_verify_commit_quant)


@pytest.mark.parametrize("lens", list(COMMIT_LENS))
@pytest.mark.parametrize("bs", [16, 128, 1024])
def test_commit_quant_plain_matches_jax_at_commit_lengths(bs, lens):
    rng = np.random.RandomState(bs)
    L, T = 2, 5
    qstart = np.asarray([0, 3, bs - 3, bs - 2, 300, bs], np.int32)
    need = [-(-(q + T) // bs) if q else 0 for q in qstart]
    perm = iter(rng.permutation(np.arange(1, 1 + sum(need))))
    tables = np.zeros((6, max(need) + 1), np.int32)
    for i, n in enumerate(need):
        for j in range(n):
            tables[i, j] = next(perm)
    n_pool = 1 + sum(need)
    clen = np.asarray(COMMIT_LENS[lens], np.int32)

    def quantized(n):
        c, s = pa.kv_quant_columns(torch.from_numpy(
            rng.randn(n, KVD).astype(np.float32)), NKV)
        return c.numpy(), s.numpy()
    pools = []
    for _ in range(2):
        c, s = quantized(L * n_pool * bs)
        pools += [c.reshape(L, n_pool, bs, KVD).transpose(0, 1, 3, 2).copy(),
                  s.reshape(L, n_pool, bs, NKV).transpose(0, 1, 3, 2).copy()]
    kq, ks, vq, vs = pools
    (nk, nks), (nv, nvs) = quantized(L * 6 * T), quantized(L * 6 * T)
    new = (nk.reshape(L, 6, T, KVD), nv.reshape(L, 6, T, KVD),
           nks.reshape(L, 6, T, NKV), nvs.reshape(L, 6, T, NKV))
    want = _jax_commit_quant(
        *(jnp.asarray(a) for a in new + (kq, vq, ks, vs)),
        jnp.asarray(tables), jnp.asarray(qstart), jnp.asarray(clen))
    got = pa.paged_verify_commit_quant_plain(
        *(_t(a) for a in new + (kq, vq, ks, vs)), _t(tables), _t(qstart),
        _t(clen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:, 1:], np.asarray(w)[:, 1:])
    written = int((got[0].numpy()[:, 1:] != kq[:, 1:]).any(axis=2).sum())
    assert written == L * sum(c for c, q in zip(clen, qstart) if q > 0)


def test_quant_entries_refuse_bad_inputs():
    q, tables, pools, new = _decode_case(1, seed=3)
    pos = _t(np.asarray(POSITIONS, np.int32))
    tp = [_t(a) for a in pools]
    tn = [_t(a) for a in new]
    with pytest.raises(TypeError, match="int8"):
        pa.paged_attend_update_quant(_t(q), *tn, tp[0].float(), tp[1],
                                     *tp[2:], _t(tables), pos, 1)
    with pytest.raises(TypeError, match="float32"):
        pa.paged_attention_quant(_t(q), *tp[:2], tp[2].double(), tp[3],
                                 _t(tables), pos, 1)
    with pytest.raises(ValueError, match="scale pools"):
        pa.paged_attention_quant(_t(q), *tp[:2], tp[2][:, 1:].contiguous(),
                                 tp[3][:, 1:].contiguous(), _t(tables), pos,
                                 1)
    with pytest.raises(TypeError, match="new_ks"):
        pa.paged_attend_update_quant(_t(q), tn[0].float(), *tn[1:], *tp,
                                     _t(tables), pos, 1)
    with pytest.raises(ValueError, match="layer"):
        pa.paged_attention_quant(_t(q), *tp, _t(tables), pos, 2)
    with pytest.raises(ValueError, match="fed tokens"):
        pa.paged_attention_verify_quant(_t(q)[:, None].expand(
            -1, 9, -1, -1).contiguous(), *tp, _t(tables), pos, 1)
    with pytest.raises(ValueError, match="new_k/new_v"):
        pa.paged_verify_commit_quant(*(t[None, :, None] for t in tn), *tp,
                                     _t(tables), pos, pos)


# -- the model: decode step, prefill chunk, verify step -----------------------

TINY = dict(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=512)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.llama_tiny(**TINY)
    params = jl.init_llama_params(jcfg, seed=0)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tl.llama_tiny(**TINY), tparams


def _model_pools(tcfg, n_pool, seed):
    """Random int8 pools and positive scales at the model's geometry."""
    rng = np.random.RandomState(seed)
    kvd = tcfg.num_key_value_heads * tcfg.head_dim
    shape = (tcfg.num_hidden_layers, n_pool, kvd, BS)
    sshape = shape[:2] + (tcfg.num_key_value_heads, BS)
    return (rng.randint(-127, 128, size=shape).astype(np.int8),
            rng.randint(-127, 128, size=shape).astype(np.int8),
            (rng.rand(*sshape) * 0.05 + 0.01).astype(np.float32),
            (rng.rand(*sshape) * 0.05 + 0.01).astype(np.float32))


def _check_pools(got, want, before, written, skip_null=False):
    """``written`` [L, NP, BS] marks the written (layer, block, column)
    cells. Every other entry bitwise unchanged in both; written scales to
    2e-6 relative and written codes within one step of JAX's. With
    ``skip_null`` the null block 0, where rejected columns land in no set
    order, is left out."""
    keep = slice(1 if skip_null else 0, None)
    for i, (g, w, b) in enumerate(zip(got, want, before)):
        g, w, b = g.numpy()[:, keep], np.asarray(w)[:, keep], b[:, keep]
        mask = np.broadcast_to(written[:, keep, None, :], g.shape)
        np.testing.assert_array_equal(g[~mask], b[~mask])
        np.testing.assert_array_equal(w[~mask], b[~mask])
        if i < 2:
            d = np.abs(g[mask].astype(int) - w[mask].astype(int))
            assert d.max() <= 1, f"codes differ by {d.max()}"
            assert (d > 0).sum() <= max(2, d.size // 500), \
                f"{(d > 0).sum()} of {d.size} written codes one step apart"
        else:
            np.testing.assert_allclose(g[mask], w[mask], rtol=2e-6, atol=0)


def test_decode_step_matches_jax(model):
    jcfg, params, tcfg, tparams = model
    positions = np.asarray([5, 127, 200, 0], np.int32)  # last: padding row
    tables = np.asarray([[3, 0], [1, 0], [4, 2], [0, 0]], np.int32)
    ids = np.asarray([7, 50, 90, 0], np.int32)
    pools = _model_pools(tcfg, 5, seed=1)
    fn = jl._jitted_paged_decode_quant(jl._freeze_config(jcfg))
    jlog, *jpools = fn(params, *(jnp.asarray(a) for a in pools),
                       jnp.asarray(tables), jnp.asarray(positions),
                       jnp.asarray(ids))
    kp, vp, ks, vs = (_t(a) for a in pools)
    logits, *tpools = tl.llama_paged_decode_step(
        tparams, kp, vp, _t(tables), _t(positions), _t(ids), tcfg,
        kv_scales=(ks, vs))
    assert tpools[0] is kp and tpools[2] is ks          # written in place
    np.testing.assert_array_equal(logits.argmax(-1).numpy()[:3],
                                  np.asarray(jlog).argmax(-1)[:3])
    np.testing.assert_allclose(logits.numpy()[:3], np.asarray(jlog)[:3],
                               atol=1e-4, rtol=1e-4)
    written = np.zeros((2, 5, BS), bool)
    written[:, tables[np.arange(4), positions // BS], positions % BS] = True
    _check_pools(tpools, jpools, pools, written)


def test_prefill_chunk_matches_jax(model):
    jcfg, params, tcfg, tparams = model
    rng = np.random.RandomState(2)
    table = np.asarray([3, 1, 0], np.int32)
    start, n_live, C = 100, 29, 32                # crosses into block 1
    ids = np.zeros((C,), np.int32)
    ids[:n_live] = rng.randint(1, 96, size=n_live)
    pools = _model_pools(tcfg, 5, seed=3)
    fn = jl._jitted_paged_prefill_quant(jl._freeze_config(jcfg))
    jlog, *jpools = fn(params, *(jnp.asarray(a) for a in pools),
                       jnp.asarray(table), jnp.int32(start), jnp.asarray(ids),
                       jnp.int32(n_live))
    logits, *tpools = tl.llama_paged_prefill_chunk(
        tparams, *(_t(a) for a in pools[:2]), _t(table), start, _t(ids),
        n_live, tcfg, kv_scales=tuple(_t(a) for a in pools[2:]))
    assert int(logits.argmax()) == int(np.asarray(jlog).argmax())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    pos = start + np.arange(C)
    blk = np.where(np.arange(C) < n_live, table[pos // BS], 0)
    written = np.zeros((2, 5, BS), bool)
    written[:, blk, pos % BS] = True
    _check_pools(tpools, jpools, pools, written, skip_null=True)
    # null block 0 takes the padding tokens' columns. At layer 0 they come
    # from the embeddings alone and match JAX's; from layer 1 on JAX's
    # padding tokens attend over the stale columns past n_live, which the
    # port selects out of P.V (ROADMAP queue 3, dead KV columns)
    _check_pools([t[:1] for t in tpools], [np.asarray(j)[:1] for j in jpools],
                 [a[:1] for a in pools], written[:1])


def test_prefill_and_decode_write_the_same_bytes(model):
    """Path independence: token x at position p gives the same bytes and
    scales in layer 0, whose column depends on the token and the position
    only, whether a prefill chunk writes it (as its last live token) or a
    decode step does after a prefill of the tokens before it. The decode
    batch has the chunk's 64 rows, x in the chunk's row p, so that both
    steps compute the column by the same matrix product."""
    _, _, tcfg, tparams = model
    rng = np.random.RandomState(4)
    C, p = 64, 39
    toks = rng.randint(1, 96, size=p + 1).astype(np.int32)
    table = torch.tensor([1, 2], dtype=torch.int32)
    out = []
    for split in (False, True):
        kp, vp = tl.init_paged_kv_pool(tcfg, 3, BS, "int8", device="cpu")
        ks, vs = tl.init_paged_kv_scales(tcfg, 3, BS, device="cpu")
        n = p if split else p + 1
        ids = np.zeros((C,), np.int32)
        ids[:n] = toks[:n]
        tl.llama_paged_prefill_chunk(tparams, kp, vp, table, 0, _t(ids), n,
                                     tcfg, kv_scales=(ks, vs))
        if split:
            tables = torch.zeros((C, 2), dtype=torch.int32)
            tables[p] = table
            positions = torch.zeros((C,), dtype=torch.int32)
            positions[p] = p
            ids = torch.zeros((C,), dtype=torch.int32)
            ids[p] = int(toks[p])
            tl.llama_paged_decode_step(tparams, kp, vp, tables, positions,
                                       ids, tcfg, kv_scales=(ks, vs))
        out.append([t[0, 1, :, p].clone() for t in (kp, vp, ks, vs)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert (out[0][2] > 0).all()


# rows: (qstart, t_live, accepted proposals the fed tokens are built for)
VERIFY_ROWS = [(126, 5, 4),      # all accepted, the window crosses 128
               (9, 5, 2),        # two accepted, then a wrong proposal
               (0, 0, 0),        # padding row
               (130, 3, 2),      # t_live < T, all live proposals accepted
               (40, 5, 0)]       # the first proposal is wrong
VT = 5


def _verify_state(tcfg, tparams):
    """Int8 pools with random cached prefixes and fed tokens built by
    greedy chaining through the port's int8 verify logits, so that each
    row accepts as VERIFY_ROWS says."""
    rng = np.random.RandomState(11)
    B, max_nb, n_pool = len(VERIFY_ROWS), 3, 12
    pools = _model_pools(tcfg, n_pool, seed=12)
    tables = np.zeros((B, max_nb), np.int32)
    blocks = iter(rng.permutation(np.arange(1, n_pool)))
    qstart = np.zeros((B,), np.int32)
    t_live = np.zeros((B,), np.int32)
    fed = np.zeros((B, VT), np.int32)
    for i, (qs, tl_, _) in enumerate(VERIFY_ROWS):
        qstart[i], t_live[i] = qs, tl_
        if tl_:
            for j in range(-(-(qs + VT) // BS)):
                tables[i, j] = next(blocks)
            fed[i, 0] = rng.randint(1, 96)
    tp = [_t(a) for a in pools]
    for j in range(1, VT):
        logits, *_ = tl._verify_logits(tparams, tp[0], tp[1], _t(tables),
                                       _t(qstart), _t(fed), tcfg,
                                       kv_scales=(tp[2], tp[3]))
        out = logits.argmax(-1).numpy()
        for i, (_, tl_, acc) in enumerate(VERIFY_ROWS):
            if j < tl_:
                fed[i, j] = out[i, j - 1] if j <= acc \
                    else (out[i, j - 1] + 1) % 96
    return pools, tables, qstart, t_live, fed


def test_verify_step_matches_jax(model):
    jcfg, params, tcfg, tparams = model
    pools, tables, qstart, t_live, fed = _verify_state(tcfg, tparams)
    fn = jl._jitted_paged_verify_quant(jl._freeze_config(jcfg))
    jout, jclen, jfin, *jpools = fn(
        params, *(jnp.asarray(a) for a in pools), jnp.asarray(tables),
        jnp.asarray(qstart), jnp.asarray(t_live), jnp.asarray(fed))
    tp = [_t(a) for a in pools]
    out, clen, fin, *tpools = tl.llama_paged_verify_step(
        tparams, tp[0], tp[1], _t(tables), _t(qstart), _t(t_live), _t(fed),
        tcfg, kv_scales=(tp[2], tp[3]))
    want_clen = [acc + 1 if tl_ else 0 for _, tl_, acc in VERIFY_ROWS]
    np.testing.assert_array_equal(np.asarray(jclen), want_clen)
    np.testing.assert_array_equal(clen.numpy(), want_clen)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    written = np.zeros((2, 12, BS), bool)
    for i, (qs, _, _) in enumerate(VERIFY_ROWS):
        for t in range(want_clen[i]):
            written[:, tables[i, (qs + t) // BS], (qs + t) % BS] = True
    _check_pools(tpools, jpools, pools, written, skip_null=True)


def test_verify_step_int8_matches_sequential_decode(model):
    """The int8 verify step's tokens equal greedy int8 decode steps that
    feed the same tokens from a copy of the same pools."""
    _, _, tcfg, tparams = model
    pools, tables, qstart, t_live, fed = _verify_state(tcfg, tparams)
    tp = [_t(a) for a in pools]
    out, clen, *_ = tl.llama_paged_verify_step(
        tparams, *(t.clone() for t in tp[:2]), _t(tables), _t(qstart),
        _t(t_live), _t(fed), tcfg, kv_scales=tuple(t.clone()
                                                   for t in tp[2:]))
    live = t_live > 0
    for j in range(VT):
        logits, *_ = tl.llama_paged_decode_step(
            tparams, tp[0], tp[1], _t(tables),
            _t((qstart + j * live).astype(np.int32)),
            _t(fed[:, j]), tcfg, kv_scales=(tp[2], tp[3]))
        for i in np.flatnonzero(live):
            if j < clen[i]:
                assert int(logits[i].argmax()) == int(out[i, j])


# -- the engine ---------------------------------------------------------------

def _kv_int8_trace(cls, seed=0, lens=(7, 130)):
    """tests/test_kv_int8.py's engine trace."""
    rng = np.random.RandomState(seed)
    return [cls(rng.randint(1, 96, size=n).tolist(), max_new_tokens=5,
                arrival=float(i)) for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def engine_model():
    """tests/test_kv_int8.py's engine model."""
    jcfg = jl.llama_tiny(vocab=96, hidden=64, layers=1, heads=4, kv_heads=2,
                         seq=512)
    params = jl.init_llama_params(jcfg, seed=3)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tl.llama_tiny(vocab=96, hidden=64, layers=1,
                                       heads=4, kv_heads=2, seq=512), tparams


def _serve(**kw):
    return dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
                max_seq_len=512, **kw)


def _port_run(tparams, tcfg, reqs, **kw):
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**_serve(**kw)),
                          record_events=True, device="cpu")
    stats = eng.run(reqs, deterministic=True)
    return eng, stats, {s.req.request_id: s.generated for s in eng.finished}


def test_engine_int8_matches_jax(engine_model):
    jcfg, params, tcfg, tparams = engine_model
    jeng = JaxEngine(params, jcfg, JaxServeConfig(**_serve(kv_dtype="int8")),
                     record_events=True)
    jeng.run(_kv_int8_trace(JaxRequest), deterministic=True)
    eng, stats, streams = _port_run(tparams, tcfg,
                                    _kv_int8_trace(Request), kv_dtype="int8")
    assert streams == {s.req.request_id: s.generated for s in jeng.finished}
    assert eng.events == jeng.events
    assert all(len(t) == 5 for t in streams.values())
    assert eng.k_pool.dtype == torch.int8
    assert eng.k_scale.dtype == torch.float32
    assert eng.k_scale.shape == (1, 10, 2, 128)
    assert stats["kv_dtype"] == jeng.stats()["kv_dtype"] == "int8"
    assert eng.pool.used_blocks == 0


def test_engine_int8_replay_and_dtypes(engine_model):
    _, _, tcfg, tparams = engine_model
    reqs = lambda: _kv_int8_trace(Request, seed=4, lens=(20, 140))
    e1, _, s1 = _port_run(tparams, tcfg, reqs(), kv_dtype="int8")
    e2, _, s2 = _port_run(tparams, tcfg, reqs(), kv_dtype="int8")
    assert s1 == s2 and e1.events == e2.events
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(**_serve(kv_dtype="fp8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        tl.init_paged_kv_pool(tcfg, 4, BS, "fp8", device="cpu")
    # "auto" is the default path: model-dtype pools, no scale pools, the
    # same streams
    d, sd, sd_streams = _port_run(tparams, tcfg, reqs())
    a, sa, sa_streams = _port_run(tparams, tcfg, reqs(), kv_dtype="auto")
    assert d.k_scale is None and a.k_scale is None
    assert a.k_pool.dtype == tcfg.dtype
    assert sd_streams == sa_streams and d.events == a.events
    assert sd["kv_dtype"] == sa["kv_dtype"] == "auto"


def _spec_requests(cls):
    """tests/test_torch_spec.py's trace."""
    rng = np.random.RandomState(7)
    return [cls(rng.randint(1, 90, size=n).tolist(), max_new_tokens=8,
                arrival=float(i), request_id=i)
            for i, n in enumerate([9, 40, 130])]


def test_spec_engine_int8_matches_jax(model):
    """tests/test_torch_spec.py's ``basic`` trace with int8 KV: JAX's
    streams, events and speculative counts; the port's non-speculative
    int8 streams; int8 base pools, model-dtype draft pools."""
    jcfg, params, tcfg, tparams = model
    kw = dict(block_size=128, num_blocks=10, max_batch=2, prefill_chunk=32,
              max_seq_len=256, kv_dtype="int8", draft_k=3)
    jeng = JaxEngine(params, jcfg, JaxServeConfig(speculative=True, **kw),
                     record_events=True)
    jeng.run(_spec_requests(JaxRequest), deterministic=True)
    out = {}
    for spec in (True, False):
        eng = InferenceEngine(tparams, tcfg, ServeConfig(speculative=spec,
                                                         **kw),
                              record_events=True, device="cpu")
        stats = eng.run(_spec_requests(Request), deterministic=True)
        out[spec] = {s.req.request_id: s.generated for s in eng.finished}
        assert eng.pool.used_blocks == 0
        if spec:
            assert out[spec] == {s.req.request_id: s.generated
                                 for s in jeng.finished}
            assert eng.events == jeng.events
            keys = ("draft_k", "draft_layers", "proposed", "accepted",
                    "accept_rate")
            want = jeng.stats()["speculative"]
            assert {k: stats["speculative"][k] for k in keys} == \
                {k: want[k] for k in keys}
            assert stats["speculative"]["accepted"] > 0
            assert eng.k_pool.dtype == torch.int8
            assert eng.k_draft.dtype == tcfg.dtype
    assert out[True] == out[False]
