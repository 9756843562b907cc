"""Port parity: speculative serving in paddle_tpu_torch against paddle_tpu.

The same numpy-seeded inputs and weights go through the JAX functions
(Pallas in interpret mode on the CPU, as tests/test_speculative.py runs
them) and through the port's CPU path, where rows 6 and 8 run their plain
PyTorch versions. Held here:
  - ``paged_commit_schedule`` bitwise;
  - row 6's plain version (``paged_attention_verify_plain``) against JAX's
    ``paged_attention_verify`` in both softmax modes: the finalised acc / l
    per head (after JAX's head selection) and m + log2(l), since the two
    anchor m differently; f32 to 1e-5, bf16 to 2^-7 (P is rounded to bf16
    against another anchor in JAX's fixed-base mode, so a P may round one
    bf16 step apart: 2^-9 of |v| per term, |v| < 4 here); a qstart = 0 row
    gets the defined acc = 0, l = 0, m = -1e30;
  - ``merge_verify_partials`` to 1e-6;
  - row 8's plain version bitwise on every pool block but the null block 0
    (rejected and padding columns land there in no set order);
  - ``llama_paged_verify_step``: out, commit_len and fin_ok bitwise; in
    the pools every column but the committed ones bitwise unchanged (block
    0 aside), the committed ones bitwise the step's own k/v columns and
    JAX's to 1e-6 (the projections are summed in another order by XLA and
    torch); with padding rows, t_live < T and proposals that match partly
    (plain and weight-only int8 weights);
  - ``make_draft_model`` shares storage with the base params;
  - the speculative engine on tests/test_speculative.py's traces (basic,
    eviction, garbage draft): JAX's streams, event log and
    ``stats()["speculative"]`` counts, and the port's non-speculative
    streams.
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


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _jnp(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


# -- the commit schedule ------------------------------------------------------

_jax_schedule = jax.jit(jpa.paged_commit_schedule, static_argnums=(3, 4, 5))


def _schedule_case(seed):
    if seed is None:
        # tests/test_speculative.py::test_commit_schedule_pure's case
        return (np.asarray([[2, 3, 0, 0], [5, 0, 0, 0]], np.int32),
                np.asarray([126, 4], np.int32), np.asarray([3, 0], np.int32),
                2, 4)
    rng = np.random.RandomState(seed)
    B, max_nb, T, L = 4, 5, 1 + seed * 4, 3
    tables = rng.randint(0, 20, size=(B, max_nb)).astype(np.int32)
    qstart = rng.randint(0, max_nb * BS - T, size=B).astype(np.int32)
    qstart[0] = 126                          # a window across a block edge
    clen = rng.randint(0, T + 1, size=B).astype(np.int32)
    return tables, qstart, clen, L, T


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_commit_schedule_bitwise(seed):
    tables, qstart, clen, L, T = _schedule_case(seed)
    want = np.asarray(_jax_schedule(jnp.asarray(qstart), jnp.asarray(clen),
                                    jnp.asarray(tables), L, T, BS))
    got = pa.paged_commit_schedule(torch.from_numpy(qstart),
                                   torch.from_numpy(clen),
                                   torch.from_numpy(tables), L, T, BS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- row 6: the verify read ---------------------------------------------------

QSTART = [0, 1, 127, 129, 300]      # 0: padding row; 129 crosses a block


def _verify_inputs(rep, T, seed):
    rng = np.random.RandomState(seed)
    nkv, hd = 2, 16
    nh = nkv * rep
    B, kvd, max_nb = len(QSTART), nkv * hd, 4
    n_pool = 1 + sum(-(-q // BS) for q in QSTART)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((B, max_nb), np.int32)
    at = 0
    for i, q in enumerate(QSTART):
        n = -(-q // BS)
        tables[i, :n] = perm[at:at + n]
        at += n
    q = rng.randn(B, T, nh, hd) * (jpa._LOG2E / hd ** 0.5)
    k_pool = rng.randn(2, n_pool, kvd, BS)
    v_pool = rng.randn(2, n_pool, kvd, BS)
    return q, k_pool, v_pool, tables, np.asarray(QSTART, np.int32)


def _jax_verify(q, k_pool, v_pool, tables, qstart, dtype):
    """JAX's entry on block-diagonal rows r = t * NH + h; returns the
    finalised acc / l per head [B, T, NH, HD] and m + log2(l) [B, T, NH]."""
    B, T, nh, hd = q.shape
    nkv = k_pool.shape[2] // hd
    rep = nh // nkv
    eye = jnp.eye(nkv, dtype=dtype)
    qs = _jnp(q, dtype).reshape(B, T, nkv, rep, hd)
    q_bd = jnp.einsum("btgrd,ge->btgred", qs, eye).reshape(B, T * nh,
                                                           nkv * hd)
    acc, m, l = jpa.paged_attention_verify(
        q_bd, _jnp(k_pool, dtype), _jnp(v_pool, dtype), jnp.asarray(tables),
        jnp.asarray(qstart), 1)
    acc = jnp.einsum("btgred,ge->btgrd",
                     acc.reshape(B, T, nkv, rep, nkv, hd),
                     eye.astype(jnp.float32)).reshape(B, T, nh, hd)
    m = m[..., 0].reshape(B, T, nh)
    l = l[..., 0].reshape(B, T, nh)
    return (np.asarray(acc / l[..., None]),
            np.asarray(m + jnp.log2(l)))


@pytest.mark.parametrize("mode", ["auto", "online"])
@pytest.mark.parametrize("dtype,rep,T,atol", [
    (jnp.float32, 1, 1, 1e-5),
    (jnp.float32, 2, 5, 1e-5),
    (jnp.bfloat16, 1, 5, 2 ** -7),
    (jnp.bfloat16, 2, 3, 2 ** -7),
])
def test_verify_plain_matches_jax(monkeypatch, mode, dtype, rep, T, atol):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, k_pool, v_pool, tables, qstart = _verify_inputs(rep, T, seed=T + rep)
    want_o, want_lse = _jax_verify(q, k_pool, v_pool, tables, qstart, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    acc, m, l = pa.paged_attention_verify(
        t(q), t(k_pool), t(v_pool), torch.from_numpy(tables),
        torch.from_numpy(qstart), 1)
    live = qstart > 0
    np.testing.assert_allclose((acc / l[..., None]).numpy()[live],
                               want_o[live], atol=atol, rtol=0)
    np.testing.assert_allclose((m + torch.log2(l)).numpy()[live],
                               want_lse[live], atol=1e-4, rtol=1e-6)
    # the padding row's partials are defined, not left unwritten
    assert (acc[~torch.from_numpy(live)] == 0).all()
    assert (l[~torch.from_numpy(live)] == 0).all()
    assert (m[~torch.from_numpy(live)] == -1e30).all()


# The kernel's split-context form of row 6 (``splits`` > 1): a row's blocks
# are cut into runs of ``split_blocks(max_nb, splits)``, each run starts its
# recurrence from the max of all scores before it, and the row's live runs'
# partial states are combined in run order, unfinalised. Held like
# test_verify_plain_matches_jax over rows of up to 6 blocks (the table's
# width; 6 splits leave one block a split, the kernel's layout at bs = 128),
# f32: acc / l to 1e-5 and m + log2(l) to 1e-4 + 1e-6 |ref| (only the f32
# combine differs from one walk); with a score spread of 150 (the last
# row's blocks from slot 3 on lead by hundreds of log2 units, across split
# boundaries) in the online mode, which JAX's tile-0 anchor would overflow.
SPLIT_QSTART = [0, 1, 128, 129, 300, 700]
VERIFY_SPLITS = (1, 2, 3, 6)


def _verify_split_inputs(spread=None):
    rng = np.random.RandomState(21)
    nkv, hd, rep, T, max_nb = 2, 16, 2, 3, 6
    B, kvd = len(SPLIT_QSTART), nkv * hd
    n_pool = 1 + sum(-(-q // BS) for q in SPLIT_QSTART)
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((B, max_nb), np.int32)
    at = 0
    for i, q in enumerate(SPLIT_QSTART):
        n = -(-q // BS)
        tables[i, :n] = perm[at:at + n]
        at += n
    q = rng.randn(B, T, nkv * rep, hd) * (jpa._LOG2E / hd ** 0.5)
    k_pool = rng.randn(2, n_pool, kvd, BS)
    v_pool = rng.randn(2, n_pool, kvd, BS)
    if spread is not None:
        k_pool[:, tables[-1, 3:]] *= spread
    return q, k_pool, v_pool, tables, np.asarray(SPLIT_QSTART, np.int32)


_JAX_VERIFY_SPLIT = {}


def _check_verify_split(monkeypatch, mode, splits, spread=None):
    monkeypatch.setenv("PADDLE_TPU_FLASH_SOFTMAX", mode)
    q, k_pool, v_pool, tables, qstart = _verify_split_inputs(spread)
    if (mode, spread) not in _JAX_VERIFY_SPLIT:
        _JAX_VERIFY_SPLIT[mode, spread] = _jax_verify(
            q, k_pool, v_pool, tables, qstart, jnp.float32)
    want_o, want_lse = _JAX_VERIFY_SPLIT[mode, spread]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    acc, m, l = pa.paged_attention_verify_plain(
        t(q), t(k_pool), t(v_pool), torch.from_numpy(tables),
        torch.from_numpy(qstart), 1, splits=splits)
    live = qstart > 0
    np.testing.assert_allclose((acc / l[..., None]).numpy()[live],
                               want_o[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose((m + torch.log2(l)).numpy()[live],
                               want_lse[live], atol=1e-4, rtol=1e-6)
    dead = torch.from_numpy(~live)
    assert (acc[dead] == 0).all() and (l[dead] == 0).all()
    assert (m[dead] == -1e30).all()
    return q, k_pool, tables


@pytest.mark.parametrize("splits", VERIFY_SPLITS)
@pytest.mark.parametrize("mode", ["auto", "online"])
def test_verify_split_plain_matches_jax(monkeypatch, mode, splits):
    """Row 6's plain version at ``splits`` against JAX."""
    _check_verify_split(monkeypatch, mode, splits)


@pytest.mark.parametrize("splits", VERIFY_SPLITS)
def test_verify_split_plain_holds_a_score_spread(monkeypatch, splits):
    q, k_pool, tables = _check_verify_split(monkeypatch, "online", splits,
                                            spread=150.0)
    # the last row's later blocks lead its first three
    kt = k_pool[1, tables[-1]].reshape(6, 2, 16, BS)
    s = np.einsum("tgrd,jgdu->jtgru", q[-1].reshape(3, 2, 2, 16), kt)
    assert s[3:].max() - s[:3].max() > 200


def _verify_plain_before_splits(q, k_pool, v_pool, tables, qstart, layer):
    """Row 6's plain version as it was before the ``splits`` keyword, kept
    verbatim as the reference of the bitwise test below."""
    B, T, NH, HD = q.shape
    bs = k_pool.shape[-1]
    nkv = k_pool.shape[2] // HD
    rep = NH // nkv
    R = T * rep
    dev = q.device
    last = qstart.long() - 1
    qf = q.float().reshape(B, T, nkv, rep, HD).transpose(1, 2) \
        .reshape(B, nkv, R, HD)
    m = torch.full((B, nkv, R), float("-inf"), device=dev)
    l = torch.zeros((B, nkv, R), device=dev)
    acc = torch.zeros((B, nkv, R, HD), device=dev)
    col = torch.arange(bs, device=dev)
    for j in range(int(last.max()) // bs + 1 if B else 0):
        blk = tables[:, j].long()
        kt = k_pool[layer, blk].float().reshape(B, nkv, HD, bs)
        vt = v_pool[layer, blk].float().reshape(B, nkv, HD, bs)
        s = torch.einsum("bgrd,bgdt->bgrt", qf, kt)
        live = (j * bs + col)[None, :] <= last[:, None]
        s = torch.where(live[:, None, None, :], s,
                        torch.tensor(-1e30, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrt,bgdt->bgrd", p.to(v_pool.dtype).float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    dead = (qstart <= 0)[:, None, None]
    m = torch.where(dead, torch.tensor(-1e30, device=dev), m)
    l = torch.where(dead, torch.tensor(0.0, device=dev), l)
    acc = torch.where(dead[..., None], torch.tensor(0.0, device=dev), acc)
    acc = acc.reshape(B, nkv, T, rep, HD).transpose(1, 2) \
        .reshape(B, T, NH, HD)
    m = m.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, NH)
    l = l.reshape(B, nkv, T, rep).transpose(1, 2).reshape(B, T, NH)
    return acc, m, l


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_plain_one_split_is_the_walk_before_splits(dtype):
    """``splits=1`` (and the default) is bitwise the walk before splits."""
    q, k_pool, v_pool, tables, qstart = _verify_split_inputs()
    q, kp, vp = (torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                 for a in (q, k_pool, v_pool))
    tb, qs = torch.from_numpy(tables), torch.from_numpy(qstart)
    want = _verify_plain_before_splits(q, kp, vp, tb, qs, 1)
    for got in (pa.paged_attention_verify_plain(q, kp, vp, tb, qs, 1),
                pa.paged_attention_verify_plain(q, kp, vp, tb, qs, 1,
                                                splits=1)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_merge_matches_jax():
    rng = np.random.RandomState(3)
    shape = (3, 4, 6, 16)
    acc_c, acc_f = rng.randn(*shape), rng.randn(*shape)
    m_c, m_f = rng.randn(3, 4, 6, 1) * 50, rng.randn(3, 4, 6, 1) * 50
    l_c, l_f = rng.rand(3, 4, 6, 1) + 0.5, rng.rand(3, 4, 6, 1) + 0.5
    # a padding row's masked partials: anchor -1e30, zero sums
    m_c[0], l_c[0], acc_c[0] = -1e30, 0.0, 0.0
    args = [a.astype(np.float32) for a in (acc_c, m_c, l_c, acc_f, m_f, l_f)]
    want = np.asarray(jpa.merge_verify_partials(*map(jnp.asarray, args)))
    got = pa.merge_verify_partials(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# -- row 8: the commit --------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_commit_plain_matches_jax_bitwise(dtype):
    rng = np.random.RandomState(5)
    L, T, kvd, n_pool = 2, 5, 32, 12
    tables = np.asarray([[3, 4, 0], [0, 0, 0], [7, 0, 0], [9, 10, 11]],
                        np.int32)
    qstart = np.asarray([126, 0, 3, 254], np.int32)
    clen = np.asarray([5, 0, 2, 4], np.int32)
    new_k = rng.randn(L, 4, T, kvd)
    new_v = rng.randn(L, 4, T, kvd)
    k_pool = rng.randn(L, n_pool, kvd, BS)
    v_pool = rng.randn(L, n_pool, kvd, BS)
    jk, jv = jpa.paged_verify_commit(
        _jnp(new_k, dtype), _jnp(new_v, dtype), _jnp(k_pool, dtype),
        _jnp(v_pool, dtype), jnp.asarray(tables), jnp.asarray(qstart),
        jnp.asarray(clen))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    kp, vp = pa.paged_verify_commit(
        t(new_k), t(new_v), t(k_pool), t(v_pool), torch.from_numpy(tables),
        torch.from_numpy(qstart), torch.from_numpy(clen))
    np.testing.assert_array_equal(_np(kp)[:, 1:],
                                  np.asarray(jk, np.float32)[:, 1:])
    np.testing.assert_array_equal(_np(vp)[:, 1:],
                                  np.asarray(jv, np.float32)[:, 1:])
    # the accepted columns landed, the rejected one did not
    np.testing.assert_array_equal(_np(kp)[1, 4, :, 0], _np(t(new_k))[1, 0, 2])
    np.testing.assert_array_equal(_np(kp)[0, 7, :, 5], _np(t(k_pool))[0, 7, :, 5])


# Row 8's plain version (the card's oracle) to JAX's commit (interpret
# mode, jitted) at the card checks' cases: commit lengths all 0, all 1
# (the serve-spec step's), all T and mixed; windows across a block edge
# (qstart bs - 3, bs - 2); block sizes 16 to 1024; row 0 a padding row
COMMIT_LENS = {"none": [0] * 6, "one": [1] * 6, "all": [5] * 6,
               "mixed": [0, 5, 3, 5, 1, 4]}
_jax_commit = jax.jit(jpa.paged_verify_commit)


def commit_layout(rng, bs, T=5):
    """The cases' qstart and fragmented tables that hold each row's cached
    and fed positions (qstart 0: a padding row on the null table);
    returns (qstart, tables, pool size)."""
    qstart = [0, 3, bs - 3, bs - 2, 300, bs]
    need = [-(-(q + T) // bs) if q else 0 for q in qstart]
    perm = iter(rng.permutation(np.arange(1, 1 + sum(need))))
    tables = np.zeros((len(qstart), max(need) + 1), np.int32)
    for i, n in enumerate(need):
        for j in range(n):
            tables[i, j] = next(perm)
    return np.asarray(qstart, np.int32), tables, 1 + sum(need)


@pytest.mark.parametrize("lens", list(COMMIT_LENS))
@pytest.mark.parametrize("bs", [16, 128, 1024])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_commit_plain_matches_jax_at_commit_lengths(dtype, bs, lens):
    rng = np.random.RandomState(bs)
    L, T, kvd = 2, 5, 32
    qstart, tables, n_pool = commit_layout(rng, bs)
    clen = np.asarray(COMMIT_LENS[lens], np.int32)
    new_k, new_v = rng.randn(L, 6, T, kvd), rng.randn(L, 6, T, kvd)
    k_pool, v_pool = rng.randn(L, n_pool, kvd, bs), rng.randn(L, n_pool,
                                                             kvd, bs)
    jk, jv = _jax_commit(
        _jnp(new_k, dtype), _jnp(new_v, dtype), _jnp(k_pool, dtype),
        _jnp(v_pool, dtype), jnp.asarray(tables), jnp.asarray(qstart),
        jnp.asarray(clen))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
    kp, vp = pa.paged_verify_commit_plain(
        t(new_k), t(new_v), t(k_pool), t(v_pool), torch.from_numpy(tables),
        torch.from_numpy(qstart), torch.from_numpy(clen))
    np.testing.assert_array_equal(_np(kp)[:, 1:],
                                  np.asarray(jk, np.float32)[:, 1:])
    np.testing.assert_array_equal(_np(vp)[:, 1:],
                                  np.asarray(jv, np.float32)[:, 1:])
    # every live column of a real block landed
    kp0 = _np(t(k_pool))
    written = int((_np(kp)[:, 1:] != kp0[:, 1:]).any(axis=2).sum())
    assert written == L * sum(c for c, q in zip(clen, qstart) if q > 0)


# -- the model: draft and verify step -----------------------------------------

TINY = dict(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2, seq=512)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.llama_tiny(**TINY)
    params = jl.init_llama_params(jcfg, seed=0)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tl.llama_tiny(**TINY), tparams


def test_draft_model_shares_storage(model):
    _, _, tcfg, tparams = model
    dparams, dcfg = tl.make_draft_model(tparams, tcfg)
    assert dcfg.num_hidden_layers == 1
    assert tcfg.num_hidden_layers == 2
    for key in ("embed", "final_norm", "lm_head"):
        assert dparams[key] is tparams[key]
    for key, w in tparams["layers"].items():
        d = dparams["layers"][key]
        assert d.shape == (1,) + w.shape[1:]
        assert d.data_ptr() == w.data_ptr()          # a view: no copy
        assert d._base is w
    deep, dcfg2 = tl.make_draft_model(tparams, tcfg, num_layers=9)
    assert dcfg2.num_hidden_layers == 2
    assert deep["layers"]["q_proj"].data_ptr() == \
        tparams["layers"]["q_proj"].data_ptr()


# rows: (qstart, t_live, accepted proposals the fed tokens are built for)
VERIFY_ROWS = [(126, 5, 4),      # all accepted, the window crosses 128
               (9, 5, 2),        # two accepted, then a wrong proposal
               (0, 0, 0),        # padding row
               (130, 3, 2),      # t_live < T, all live proposals accepted
               (40, 5, 0)]       # the first proposal is wrong
VT = 5


def _verify_state(tcfg, tparams):
    """Pools with random cached prefixes and fed tokens built by greedy
    chaining through the port's verify logits, so that each row accepts
    exactly as VERIFY_ROWS says."""
    rng = np.random.RandomState(11)
    B, max_nb, n_pool = len(VERIFY_ROWS), 3, 12
    kvd = tcfg.num_key_value_heads * tcfg.head_dim
    k_pool = rng.randn(2, n_pool, kvd, BS).astype(np.float32)
    v_pool = rng.randn(2, n_pool, kvd, BS).astype(np.float32)
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
    args = [torch.from_numpy(a) for a in (k_pool, v_pool, tables, qstart)]
    for j in range(1, VT):
        logits, _, _ = tl._verify_logits(tparams, *args,
                                         torch.from_numpy(fed), tcfg)
        out = logits.argmax(-1).numpy()
        for i, (_, tl_, acc) in enumerate(VERIFY_ROWS):
            if j < tl_:
                fed[i, j] = out[i, j - 1] if j <= acc \
                    else (out[i, j - 1] + 1) % 96
    return k_pool, v_pool, tables, qstart, t_live, fed


@pytest.mark.parametrize("weights", ["plain", "int8"])
def test_verify_step_matches_jax(model, weights):
    jcfg, params, tcfg, _ = model
    if weights == "int8":
        params = jl.quantize_llama_int8(params)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    k_pool, v_pool, tables, qstart, t_live, fed = _verify_state(tcfg,
                                                                tparams)
    fn = jl._jitted_paged_verify(jl._freeze_config(jcfg))
    jout, jclen, jfin, jk, jv = fn(
        params, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(qstart), jnp.asarray(t_live),
        jnp.asarray(fed))
    out, clen, fin, kp, vp = tl.llama_paged_verify_step(
        tparams, torch.from_numpy(k_pool.copy()),
        torch.from_numpy(v_pool.copy()), torch.from_numpy(tables),
        torch.from_numpy(qstart), torch.from_numpy(t_live),
        torch.from_numpy(fed), tcfg)
    want_clen = [acc + 1 if tl_ else 0 for _, tl_, acc in VERIFY_ROWS]
    np.testing.assert_array_equal(np.asarray(jclen), want_clen)
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    assert out.dtype == torch.int32 and clen.dtype == torch.int32
    # the pools: every column but the committed ones untouched, bitwise;
    # the committed columns are the step's own k/v columns, bitwise, and
    # JAX's to f32 rounding (XLA and torch sum the projections in
    # another order)
    _, k_cols, v_cols = tl._verify_logits(
        tparams, *(torch.from_numpy(a) for a in (k_pool, v_pool, tables,
                                                 qstart, fed)), tcfg)
    sc = pa.paged_commit_schedule(torch.from_numpy(qstart), clen,
                                  torch.from_numpy(tables), 2, VT, BS).long()
    li, bid, col, _, bi, ti = sc[:, sc[1] > 0]
    for got, want, ref, cols in ((kp, jk, k_pool, k_cols),
                                 (vp, jv, v_pool, v_cols)):
        want = np.asarray(want)
        touched = np.zeros(ref.shape, bool)
        touched[li, bid, :, col] = True
        touched[:, 0] = True                     # the null block
        np.testing.assert_array_equal(got.numpy()[~touched], ref[~touched])
        np.testing.assert_array_equal(want[~touched], ref[~touched])
        assert torch.equal(got[li, bid, :, col], cols[li, bi, ti])
        np.testing.assert_allclose(got.numpy()[li, bid, :, col],
                                   want[li, bid, :, col], atol=1e-6, rtol=0)


def test_verify_step_refuses_what_is_not_ported(model):
    _, _, tcfg, tparams = model
    kp, vp = tl.init_paged_kv_pool(tcfg, 4, BS, device="cpu")
    z = torch.zeros((1,), dtype=torch.int32)
    args = (kp, vp, torch.zeros((1, 2), dtype=torch.int32), z, z,
            torch.zeros((1, 2), dtype=torch.int32), tcfg)
    # tensor parallelism is ported: a group of one rank is the plain step
    from paddle_tpu_torch.distributed.communication import Group
    plain = tl.llama_paged_verify_step(tparams, kp.clone(), vp.clone(),
                                       *args[2:])
    one = tl.llama_paged_verify_step(tparams, kp.clone(), vp.clone(),
                                     *args[2:], tp=Group("mp", 1))
    assert all(torch.equal(a, b) for a, b in zip(plain, one))
    fused = dict(tparams, layers=dict(tparams["layers"], qkv_proj=None))
    with pytest.raises(ValueError, match="qkv_proj"):
        tl.llama_paged_verify_step(fused, *args)


# -- the engine ---------------------------------------------------------------

def _requests(cls):
    rng = np.random.RandomState(7)
    return [cls(rng.randint(1, 90, size=n).tolist(), max_new_tokens=8,
                arrival=float(i), request_id=i)
            for i, n in enumerate([9, 40, 130])]


def _serve(num_blocks, **kw):
    return dict(block_size=128, num_blocks=num_blocks, max_batch=2,
                prefill_chunk=32, max_seq_len=256, **kw)


TRACES = {"basic": dict(num_blocks=10, draft_k=3),
          "evict": dict(num_blocks=5, draft_k=4),
          "garbage": dict(num_blocks=10, draft_k=2, garbage=True)}


@pytest.fixture(scope="module")
def port_reference(model):
    _, _, tcfg, tparams = model
    eng = InferenceEngine(tparams, tcfg, ServeConfig(**_serve(10)),
                          device="cpu")
    eng.run(_requests(Request), deterministic=True)
    return {s.req.request_id: s.generated for s in eng.finished}


@pytest.fixture(scope="module", params=sorted(TRACES))
def spec_pair(request, model):
    jcfg, params, tcfg, tparams = model
    kw = dict(TRACES[request.param])
    nb, k = kw.pop("num_blocks"), kw.pop("draft_k")
    jdraft, tdraft = {}, {}
    if kw.pop("garbage", False):
        _, jdcfg = jl.make_draft_model(params, jcfg)
        jdp = jl.init_llama_params(jdcfg, seed=99)
        jdraft = dict(draft_params=jdp, draft_config=jdcfg)
        tdraft = dict(draft_params=tl.params_from_numpy(
            jax.tree.map(np.asarray, jdp), "cpu"),
            draft_config=tl.make_draft_model(tparams, tcfg)[1])
    with _common.interpret_mode(True):
        jeng = JaxEngine(params, jcfg, JaxServeConfig(
            **_serve(nb, speculative=True, draft_k=k)), record_events=True,
            **jdraft)
        jeng.run(_requests(JaxRequest), deterministic=True)
    teng = InferenceEngine(tparams, tcfg, ServeConfig(
        **_serve(nb, speculative=True, draft_k=k)), record_events=True,
        device="cpu", **tdraft)
    stats = teng.run(_requests(Request), deterministic=True)
    return request.param, jeng, teng, stats


def test_spec_engine_matches_jax(spec_pair, port_reference):
    trace, jeng, teng, stats = spec_pair
    streams = {s.req.request_id: s.generated for s in teng.finished}
    assert streams == {s.req.request_id: s.generated for s in jeng.finished}
    assert streams == port_reference
    assert teng.events == jeng.events
    keys = ("draft_k", "draft_layers", "proposed", "accepted", "accept_rate")
    want = jeng.stats()["speculative"]
    assert {k: stats["speculative"][k] for k in keys} == \
        {k: want[k] for k in keys}
    assert stats["speculative"]["proposed"] > 0
    assert stats["preemptions"] == jeng.preemptions
    assert teng.pool.used_blocks == 0
    if trace == "garbage":
        assert stats["speculative"]["accept_rate"] < 1.0
