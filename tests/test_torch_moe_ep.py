"""Port parity: paddle_tpu_torch's expert-parallel MoE dispatch
(``parallel/moe.py``'s ``moe_slot_dispatch_local``,
``moe_ragged_dispatch_local``, ``moe_ragged_dispatch_a2a`` and
``moe_shard_map_dispatch``) and the ragged all-to-all
(``distributed/communication/ragged.py``) over gloo ranks on the CPU,
against the JAX package's functions in ``shard_map`` over 2 and 4 of the
conftest's devices, on the same numpy inputs.

E 8 experts of D 16 -> I 32, top-2, row tile 8, as
``tests/test_moe_skew.py``, whose skews these reuse: uniform, all-to-one
(every token's top-1 on expert 0), empty experts (the upper half never
wins) and one-token shards (T = n). The local paths take every token on
every rank (JAX's ``P()``), the a2a and the one-hot all-to-all rank r's
block r (``P("ep")``). Outputs, aux and stats are held to 1e-6, the slots
of the ep layouts bitwise to JAX's formulas, ``chunk_schedule`` bitwise
to JAX's; the a2a's four transports ({ring, dense} x {overlap, blocking})
and ``ragged_all_to_all``'s two are held bitwise to each other, forward
and gradients.

The ranks run ``paddle_tpu_torch.testing.dist.moe_dispatch_job`` (torch
and the port only): one spawn of 2 ranks and one of 4 carry every case,
each with a ``FileStore`` in its own temp directory and a join limit of
``JOIN_S`` seconds, started in a thread before this process computes
JAX's side.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu._compat import shard_map
from paddle_tpu.ops import grouped_matmul as jgmm
from paddle_tpu.parallel import moe as jmoe

from paddle_tpu_torch.ops import grouped_matmul as tgmm
from paddle_tpu_torch.testing import dist as td

E, K, D, I, TILE, JOIN_S = 8, 2, 16, 32, 8, 150
T_TOKENS = 24
SKEWS = ["uniform", "all_to_one", "empty_experts", "one_token"]
FNS = ["slot_local", "ragged_local", "a2a", "shard_map"]
A2A_VARIANTS = [("ring", False), ("ring", True), ("dense", False),
                ("dense", True)]


def _data(skew, n, seed):
    rng = np.random.RandomState(seed)
    T = n if skew == "one_token" else T_TOKENS
    logits = rng.randn(T, E).astype(np.float32)
    if skew == "all_to_one":
        logits[:, 0] += 20.0
    elif skew == "empty_experts":
        logits[:, E // 2:] -= 30.0
    return {"x": rng.randn(T, D).astype(np.float32), "logits": logits,
            "w1": (rng.randn(E, D, I) / 4).astype(np.float32),
            "w2": (rng.randn(E, I, D) / 4).astype(np.float32),
            "cot": rng.randn(T, D).astype(np.float32)}


def _cases(n):
    cases, arrays = [], {}
    for i, skew in enumerate(SKEWS):
        data = f"{skew}"
        for name, a in _data(skew, n, 10 * n + i).items():
            arrays[f"{data}/{name}"] = a
        for fn in FNS:
            cases.append(dict(name=f"{fn}/{skew}", data=data, fn=fn))
        for impl, overlap in A2A_VARIANTS:
            cases.append(dict(name=f"a2a_{impl}_{int(overlap)}/{skew}",
                              data=data, fn="a2a",
                              kwargs=dict(a2a_impl=impl, overlap=overlap)))
    # the exchange alone: uneven dest-sorted rows, counts up to peer_rows
    rng = np.random.RandomState(n)
    peer, R = 5, 5 * n
    counts = rng.randint(0, peer + 1, size=(n, n))
    counts[0, :] = 0                           # rank 0 sends nothing
    arrays["ex/rows"] = rng.randn(n, R, 3).astype(np.float32)
    arrays["ex/send_counts"] = counts.astype(np.int32)
    for impl in ("ring", "dense"):
        cases.append(dict(name=f"ragged_{impl}", data="ex", fn="ragged",
                          kwargs=dict(impl=impl, peer_rows=peer)))
    return cases, arrays


def _spawn_port(tmp_path_factory):
    """{n: (every rank's report, the inputs)} for n in (2, 4)."""
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ep{n}")
        cases, arrays = _cases(n)
        np.savez(tmp / "inputs.npz", **arrays)
        job = dict(inputs=str(tmp / "inputs.npz"), k=K, tile_rows=TILE,
                   cases=cases)
        out[n] = (td.spawn(td.moe_dispatch_job, n, (job,), timeout=JOIN_S,
                           store_dir=str(tmp)), arrays)
    return out


@pytest.fixture(scope="module")
def port_future(tmp_path_factory):
    """The port's spawns, started first and run in a thread while this
    process computes JAX's side."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_spawn_port, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_islands(port_future):
    """{(n, fn, skew): JAX's island} for every dispatch case."""
    return {(n, fn, skew): _jax_island(fn, n, dict(_cases(n)[1]), skew)
            for n in (2, 4) for fn in FNS for skew in SKEWS}


@pytest.fixture(scope="module")
def port(port_future, jax_islands):
    return port_future.result()


def _expert_fn(params, toks):
    w1, w2 = params
    return jax.nn.gelu(toks @ w1) @ w2


def _jax_island(fn, n, arrays, data):
    """JAX's function in shard_map over n devices: (out, aux per rank,
    stats per rank) as numpy."""
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("ep",))
    sharded = fn in ("a2a", "shard_map")
    tok = P("ep") if sharded else P()

    def island(x, lg, w1, w2):
        if fn == "slot_local":
            o, a, st = jmoe.moe_slot_dispatch_local(
                x, lg, _expert_fn, (w1, w2), E, axis_name="ep", k=K,
                return_stats=True)
        elif fn == "ragged_local":
            o, a, st = jmoe.moe_ragged_dispatch_local(
                x, lg, w1, w2, E, axis_name="ep", k=K, tile_rows=TILE,
                return_stats=True)
        elif fn == "a2a":
            o, a, st = jmoe.moe_ragged_dispatch_a2a(
                x, lg, w1, w2, E, axis_name="ep", k=K, tile_rows=TILE,
                a2a_impl="ring", overlap=False, return_stats=True)
        else:
            o, a, st = jmoe.moe_shard_map_dispatch(
                x, lg, _expert_fn, (w1, w2), E, axis_name="ep", k=K,
                return_stats=True)
        return o, a[None], {k_: v[None] for k_, v in st.items()}
    stats_spec = jax.tree_util.tree_map(
        lambda _: P("ep"), jmoe.zero_routing_stats(
            "ragged_a2a" if fn == "a2a" else
            "ragged" if fn == "ragged_local" else "capacity", E))
    f = jax.jit(shard_map(island, mesh=mesh,
                          in_specs=(tok, tok, P("ep"), P("ep")),
                          out_specs=(tok, P("ep"), stats_spec),
                          check_vma=False))
    o, a, st = f(*(jnp.asarray(arrays[f"{data}/{k_}"])
                   for k_ in ("x", "logits", "w1", "w2")))
    return (np.asarray(o), np.asarray(a),
            {k_: np.asarray(v) for k_, v in st.items()})


def _jax_slots(fn, n, arrays, data, rank):
    """The slots of rank ``rank``'s layout, computed with JAX's own
    formulas (``paddle_tpu/parallel/moe.py``) on its tokens."""
    lg = jnp.asarray(arrays[f"{data}/logits"])
    el = E // n
    if fn == "a2a":
        t = lg.shape[0] // n
        lg = lg[rank * t:(rank + 1) * t]
    T = lg.shape[0]
    if fn == "slot_local":
        cap = jmoe.moe_capacity(T, K, E, 1.25)[0]
        slot = jmoe.topk_route(lg, K, cap)[0]
        loc = slot - rank * el * cap
        mine = (loc >= 0) & (loc < el * cap)
        return np.asarray(jnp.where(mine, loc, el * cap))
    _, experts = lax.top_k(jax.nn.softmax(lg, axis=-1), K)
    e_flat = experts.reshape(-1)
    if fn == "ragged_local":
        le = e_flat - rank * el
        mine = (le >= 0) & (le < el)
        le_t = jnp.where(mine, le, el)
        oh = jax.nn.one_hot(le_t, el + 1, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh,
                                  le_t[:, None], axis=1)[:, 0]
        counts = oh.sum(axis=0)[:el]
        offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(
            jmoe._round_up(counts, TILE)).astype(jnp.int32)])
        n_rows = jmoe.ragged_buffer_rows(T, K, el, TILE)
        return np.asarray(jnp.where(mine, offsets[le_t] + pos, n_rows))
    oh = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - oh,
                              e_flat[:, None], axis=1)[:, 0]
    counts_mat = oh.sum(axis=0).reshape(n, el)
    off_within = jnp.concatenate([
        jnp.zeros((n, 1), jnp.int32),
        jnp.cumsum(jmoe._round_up(counts_mat, TILE), axis=1)
        .astype(jnp.int32)[:, :-1]], axis=1)
    chunk = jmoe.ragged_buffer_rows(T, K, el, TILE)
    dest, le = e_flat // el, e_flat % el
    return np.asarray((dest - rank) % n * chunk + off_within[dest, le] + pos)


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_matches_jax(port, jax_islands, n, fn, skew):
    """Outputs, aux and stats within 1e-6 of JAX's island; slots bitwise
    JAX's formulas; no rank imported JAX."""
    reports, arrays = port[n]
    o, a, st = jax_islands[(n, fn, skew)]
    name = f"{fn}/{skew}"
    got = [r["cases"][name] for r in reports]
    if fn in ("a2a", "shard_map"):
        out = np.concatenate([g["out"] for g in got])
    else:
        out = got[0]["out"]
        for g in got:       # the partials summed: the same on every rank
            np.testing.assert_array_equal(g["out"], out)
    np.testing.assert_allclose(out, o, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose([g["aux"] for g in got], a, rtol=1e-6)
    for r, g in enumerate(got):
        assert g["stats"].keys() == st.keys()
        for key, want in st.items():
            np.testing.assert_allclose(g["stats"][key], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        if fn != "shard_map":
            np.testing.assert_array_equal(
                g["slot"], _jax_slots(fn, n, arrays, skew, r))
    if fn in ("ragged_local", "a2a"):     # dropless under any skew
        assert all(float(g["stats"]["moe_dropped_tokens"]) == 0 for g in got)
    assert not any(r["jax_modules"] for r in reports)


@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("n", [2, 4])
def test_a2a_transports_are_bitwise_equal(port, n, skew):
    """The a2a's four transports ({ring, dense} x {overlap, blocking})
    give the same bits: outputs, aux, stats and the gradients of x,
    logits, w1 and w2; the hop counters count n - 1 hops, overlapped ones
    only on the overlapped ring."""
    reports, _ = port[n]
    for r in reports:
        runs = {v: r["cases"][f"a2a_{v[0]}_{int(v[1])}/{skew}"]
                for v in A2A_VARIANTS}
        base = runs[("ring", False)]
        for v, got in runs.items():
            np.testing.assert_array_equal(got["out"], base["out"])
            assert got["aux"] == base["aux"]
            for key in base["stats"]:
                np.testing.assert_array_equal(got["stats"][key],
                                              base["stats"][key])
            for key in base["grads"]:
                np.testing.assert_array_equal(got["grads"][key],
                                              base["grads"][key],
                                              err_msg=f"{v} {key}")
            c = got["counters"]
            assert c["moe.a2a.hops_total"] == n - 1
            assert c.get("moe.a2a.hops_overlapped", 0) == \
                (n - 1 if v == ("ring", True) else 0)
            ring = v[0] == "ring"
            assert c.get("moe.ragged_a2a.hop.calls", 0) == \
                (n - 1 if ring else 0)
            assert c.get("moe.ragged_a2a.dense.calls", 0) == (0 if ring
                                                               else 1)
            assert c["moe.ragged_a2a.counts.calls"] == 1


@pytest.mark.parametrize("n", [2, 4])
def test_ragged_all_to_all_ring_equals_dense_and_the_layout(port, n):
    """``ragged_all_to_all``: ring and dense land the same bits, and each
    rank's out holds, at source j's chunk, the first counts rows rank j
    addressed to it and zeros after; recv_counts is the transposed count
    matrix."""
    reports, arrays = port[n]
    rows, counts = arrays["ex/rows"], arrays["ex/send_counts"]
    peer = 5
    for me, r in enumerate(reports):
        ring, dense = r["cases"]["ragged_ring"], r["cases"]["ragged_dense"]
        np.testing.assert_array_equal(ring["out"], dense["out"])
        np.testing.assert_array_equal(ring["recv"], counts[:, me])
        want = np.zeros((n * peer, 3), np.float32)
        for j in range(n):
            off = counts[j, :me].sum()
            c = counts[j, me]
            want[j * peer:j * peer + c] = rows[j, off:off + c]
        np.testing.assert_array_equal(ring["out"], want)


@pytest.mark.parametrize("counts", [[0, 0, 0, 0], [1, 0, 17, 8],
                                    [64, 0, 0, 0], [3, 9, 0, 30]])
@pytest.mark.parametrize("tile", [8, 128])
def test_chunk_schedule_is_jax_bitwise(counts, tile):
    chunk = jmoe.ragged_buffer_rows(40, 2, 4, tile)
    want = jgmm.chunk_schedule(jnp.asarray(counts, jnp.int32), chunk, tile)
    got = tgmm.chunk_schedule(torch.tensor(counts, dtype=torch.int32),
                              chunk, tile)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="chunk_rows"):
        tgmm.chunk_schedule(torch.tensor(counts, dtype=torch.int32),
                            chunk + 1, tile)
