"""Dead KV columns never reach a result in the port (paddle_tpu_torch).

A column is dead for a row when it lies past the row's length, in a dead
table slot or in null block 0. The masks kill only the scores; P.V would
still multiply an exact 0 by the dead column's V, and 0 * NaN is NaN. The
port SELECTS dead columns out instead, so stale NaN left in a pool (a
quarantined request's freed blocks, the padding columns of a poisoned
chunk in block 0) cannot poison a later request.

Each probe runs on a tiny 2-layer Llama (GQA 4/2, head_dim 16) in bf16
with model-dtype pools and with int8 pools, on the CPU (the kernels'
plain versions): the output over a poisoned pool must be finite and
bitwise equal to the output over a clean pool. One test pins that the
JAX package's prefill turns such a pool into non-finite logits, the
difference the port makes on purpose.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.ops import _common

from paddle_tpu_torch.models import llama as tl

BS, NP, MAX_NB, C = 128, 6, 4, 32
POISON = 95


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                         seq=512)
    return jcfg, jax.tree.map(np.asarray, jl.init_llama_params(jcfg, seed=5))


def _port(weights, dtype):
    """The port's model in ``dtype`` with token POISON's embedding row
    NaN (a genuine poison input)."""
    _, host = weights
    cfg = dataclasses.replace(
        tl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                      seq=512), dtype=dtype)
    params = tl.params_from_numpy(host, "cpu")
    params = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dtype))
              for k, v in params.items()}
    params["embed"][POISON] = float("nan")
    return cfg, params


def _pools(cfg, kv_dtype):
    k, v = tl.init_paged_kv_pool(cfg, NP, BS, kv_dtype=kv_dtype,
                                 device="cpu")
    scales = (tl.init_paged_kv_scales(cfg, NP, BS, device="cpu")
              if kv_dtype == "int8" else None)
    return k, v, scales


def _prefill(cfg, params, pools, table, ids, n_live, start=0):
    k, v, scales = pools
    out = tl.llama_paged_prefill_chunk(
        params, k, v, torch.tensor(table, dtype=torch.int32), start,
        torch.tensor(ids, dtype=torch.int32), n_live, cfg,
        kv_scales=scales)
    return out[0]


def _ids(seed, n, poison_at=None):
    ids = np.zeros((C,), np.int32)
    ids[:n] = np.random.RandomState(seed).randint(1, POISON, size=n)
    if poison_at is not None:
        ids[poison_at] = POISON
    return ids


CASES = [(torch.bfloat16, "auto"), (torch.bfloat16, "int8")]


@pytest.mark.parametrize("dtype,kv_dtype", CASES)
def test_poisoned_prefill_cannot_reach_a_clean_prefill(weights, dtype,
                                                       kv_dtype):
    """A 24-of-32-token chunk holding the NaN token leaves NaN in its own
    block and in block 0 (its padding columns, from layer 1 on); a clean
    32-token prefill on disjoint blocks then matches its fresh-pool logits
    bit for bit."""
    cfg, params = _port(weights, dtype)
    pools = _pools(cfg, kv_dtype)
    bad = _prefill(cfg, params, pools, [1, 0, 0, 0], _ids(0, 24, 10), 24)
    assert not torch.isfinite(bad).all()
    held = pools[2][0] if kv_dtype == "int8" else pools[0]   # int8: scales
    assert not torch.isfinite(held[1, 0].float()).all(), \
        "the probe must leave NaN in block 0"
    clean_ids = _ids(1, 32)
    got = _prefill(cfg, params, pools, [2, 3, 0, 0], clean_ids, 32)
    want = _prefill(cfg, params, _pools(cfg, kv_dtype), [2, 3, 0, 0],
                    clean_ids, 32)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # a chunk over a cached prefix (start > 0) reads block 0 through its
    # dead table slots too
    more = _ids(2, 20)
    got2 = _prefill(cfg, params, pools, [2, 3, 0, 0], more, 20, start=32)
    fresh = _pools(cfg, kv_dtype)
    _prefill(cfg, params, fresh, [2, 3, 0, 0], clean_ids, 32)
    want2 = _prefill(cfg, params, fresh, [2, 3, 0, 0], more, 20, start=32)
    assert torch.isfinite(got2).all() and torch.equal(got2, want2)


def _stale(pools, blk, from_col):
    """NaN in every column of ``blk`` from ``from_col`` on and all of
    block 0, every layer: int8 pools take it in their f32 scale pools,
    model-dtype pools in K and V."""
    k, v, scales = pools
    for t in ((k, v) if scales is None else scales):
        t[:, blk, :, from_col:] = float("nan")
        t[:, 0] = float("nan")


def _decode(cfg, params, pools, tables, positions, ids):
    k, v, scales = pools
    return tl.llama_paged_decode_step(
        params, k, v, torch.tensor(tables, dtype=torch.int32),
        torch.tensor(positions, dtype=torch.int32),
        torch.tensor(ids, dtype=torch.int32), cfg, kv_scales=scales)[0]


def _verify(cfg, params, pools, tables, qstart, t_live, fed):
    k, v, scales = pools
    out = tl.llama_paged_verify_step(
        params, k, v, torch.tensor(tables, dtype=torch.int32),
        torch.tensor(qstart, dtype=torch.int32),
        torch.tensor(t_live, dtype=torch.int32),
        torch.tensor(fed, dtype=torch.int32), cfg, kv_scales=scales)
    return out[:3]


def _two_rows(cfg, params, kv_dtype):
    """Pools holding two cached rows: 20 tokens in block 3 and 150 tokens
    over blocks 4, 5 (the second row's last block partly live)."""
    pools = _pools(cfg, kv_dtype)
    _prefill(cfg, params, pools, [3, 0, 0, 0], _ids(3, 20), 20)
    ids = np.random.RandomState(4).randint(1, POISON, size=150)
    _prefill(cfg, params, pools, [4, 5, 0, 0], ids[:128], 128)
    tail = np.zeros((C,), np.int32)
    tail[:22] = ids[128:]
    _prefill(cfg, params, pools, [4, 5, 0, 0], tail, 22, start=128)
    return pools


@pytest.mark.parametrize("dtype,kv_dtype", CASES)
def test_stale_nan_past_length_cannot_reach_decode(weights, dtype, kv_dtype):
    """NaN past each row's length (in the row's own last block) and in
    block 0, then a decode step with a padding row: the live rows' logits
    equal those over the clean pools bit for bit."""
    cfg, params = _port(weights, dtype)
    tables = [[3, 0, 0, 0], [4, 5, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    positions, ids = [20, 150, 0, 0], [7, 11, 0, 0]
    clean = _two_rows(cfg, params, kv_dtype)
    dirty = _two_rows(cfg, params, kv_dtype)
    _stale(dirty, 3, 21)
    _stale(dirty, 5, 23)
    got = _decode(cfg, params, dirty, tables, positions, ids)[:2]
    want = _decode(cfg, params, clean, tables, positions, ids)[:2]
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,kv_dtype", CASES)
def test_stale_nan_past_length_cannot_reach_verify(weights, dtype, kv_dtype):
    """The same stale pools under a verify step of 3 fed tokens a row
    (and a padding row): tokens, commit lengths and the finite screen
    equal those over the clean pools."""
    cfg, params = _port(weights, dtype)
    tables = [[3, 0, 0, 0], [4, 5, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    fed = [[7, 9, 13], [11, 2, 5], [0, 0, 0], [0, 0, 0]]
    qstart, t_live = [20, 150, 0, 0], [3, 3, 0, 0]
    clean = _two_rows(cfg, params, kv_dtype)
    dirty = _two_rows(cfg, params, kv_dtype)
    _stale(dirty, 3, 23)
    _stale(dirty, 5, 25)
    got = _verify(cfg, params, dirty, tables, qstart, t_live, fed)
    want = _verify(cfg, params, clean, tables, qstart, t_live, fed)
    assert bool(got[2][:2].all())
    for g, w in zip(got, want):
        assert torch.equal(g[:2], w[:2])


def test_poisoned_fed_token_stays_in_its_own_positions(weights):
    """Within the verify step's fed block, a NaN proposal at position u
    never reaches the outputs of positions t < u (they are selected, not
    weighted by 0)."""
    cfg, params = _port(weights, torch.float32)
    tables = [[3, 0, 0, 0]]
    pools = _pools(cfg, "auto")
    _prefill(cfg, params, pools, [3, 0, 0, 0], _ids(3, 20), 20)
    k, v, _ = pools
    logits, *_ = tl._verify_logits(
        params, k, v, torch.tensor(tables, dtype=torch.int32),
        torch.tensor([20], dtype=torch.int32),
        torch.tensor([[7, 9, POISON]], dtype=torch.int32), cfg)
    assert torch.isfinite(logits[0, :2]).all()
    assert not torch.isfinite(logits[0, 2]).all()


def test_jax_prefill_turns_a_poisoned_pool_into_nan(weights):
    """The JAX package's paged prefill, after the poisoned chunk of
    :func:`test_poisoned_prefill_cannot_reach_a_clean_prefill`, returns
    non-finite logits for the clean request on disjoint blocks (a known
    difference: the port's repair selects dead columns out)."""
    jcfg, host = weights
    params = jax.tree.map(jnp.asarray, host)
    params["embed"] = params["embed"].at[POISON].set(jnp.nan)
    k, v = jl.init_paged_kv_pool(jcfg, NP, BS)

    def prefill(k, v, table, ids, n_live):
        return jl.llama_paged_prefill_chunk(
            params, k, v, jnp.asarray(table, jnp.int32), jnp.int32(0),
            jnp.asarray(ids), jnp.int32(n_live), jcfg)

    _, k, v = prefill(k, v, [1, 0, 0, 0], _ids(0, 24, 10), 24)
    clean, _, _ = prefill(k, v, [2, 3, 0, 0], _ids(1, 32), 32)
    fresh, _, _ = prefill(*jl.init_paged_kv_pool(jcfg, NP, BS),
                          [2, 3, 0, 0], _ids(1, 32), 32)
    assert np.isfinite(np.asarray(fresh)).all()
    assert not np.isfinite(np.asarray(clean)).all()
    # the port, in the same f32 model, stays finite and equal to fresh
    cfg, tparams = _port(weights, torch.float32)
    pools = _pools(cfg, "auto")
    _prefill(cfg, tparams, pools, [1, 0, 0, 0], _ids(0, 24, 10), 24)
    got = _prefill(cfg, tparams, pools, [2, 3, 0, 0], _ids(1, 32), 32)
    want = _prefill(cfg, tparams, _pools(cfg, "auto"), [2, 3, 0, 0],
                    _ids(1, 32), 32)
    assert torch.isfinite(got).all() and torch.equal(got, want)
