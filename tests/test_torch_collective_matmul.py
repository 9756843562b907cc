"""Port parity: paddle_tpu_torch's tensor-parallel rings
(``parallel/collective_matmul.py``) against the port's own blocking path,
and against paddle_tpu's shard_map islands, on the CPU.

The ranks are gloo processes, one spawn of 2 and one of 4, each joined
within ``JOIN_S`` seconds; the world is one mp group. Each runs
``paddle_tpu_torch.testing.dist.collective_job`` (torch and the port
only) on its part of the same f32 operands, made here from a seed, under
the loss sum(out * G): the row-parallel ring (``rar``), the
column-parallel ring (``rag``, its input through ``copy_to_mp``), the
bare reduce (``rr``) and gather (``rg``) rings, each unchunked and with
4 sub-tiles a hop; the row and column plans over those rings; the fused
FFN plan; the vocabulary-parallel embedding
plan; the parallel cross entropy plan; and each one's blocking
counterpart (``reduce_from_mp``, ``gather_from_mp``, the decoder's FFN,
``vocab_parallel_embed``, ``_VocabParallelCE``).

The contract (PARITY.md, "TP-overlap numerics contract"): at mp 2 every
ring is bitwise its blocking counterpart, forward and backward; the
gather rings stay bitwise at mp 4, chunked or not; the reduce rings at
mp 4 match to f32 tolerance; chunking is bitwise neutral; the embedding's
ring sum and the cross entropy's picked logit are exact.

The same operands go through JAX's rings, blocking islands and plans on
its 8-device CPU mesh (``n`` devices), held within f32 tolerance
(``RTOL``/``ATOL``), never bitwise: JAX's own ring-vs-blocking bitwise
tests fail on the reference (ROADMAP.md queue 3).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu._compat import shard_map
from paddle_tpu.parallel import collective_matmul as jcm

from paddle_tpu_torch.testing import dist as td

JOIN_S = 150
MIN_CHUNK = "16"
RTOL, ATOL = 1e-5, 1e-5
# (t, k, out) of the products, (b, s, H, I) of the FFN, (V, H) of the
# table, V of the logits
T, K, OUT = 128, 32, 48
FFN = (2, 64, 32, 128)
VOCAB, EMB_H = 96, 32
ENV = {"PADDLE_TPU_TORCH_TP_OVERLAP_MIN_CHUNK": MIN_CHUNK}
# (case, form) held bitwise to the case's blocking path at mp 2
MP2_FORMS = [(name, form) for name in ("rar", "rag", "rr", "rg")
             for form in ("ring", "ring:chunks4")] + [
    ("rar", "plan"), ("rag", "plan"), ("ffn", "ring"), ("embed", "ring")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{n: (the global inputs, every rank's cases in rank order)}."""
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"mp{n}")
        a = td.collective_inputs(n, T, K, OUT, FFN, VOCAB, EMB_H)
        np.savez(tmp / "inputs.npz", **a)
        job = {"inputs": str(tmp / "inputs.npz"), "env": ENV}
        reports = td.spawn(td.collective_job, n, (job,), timeout=JOIN_S,
                           store_dir=str(tmp))
        assert [r["rank"] for r in reports] == list(range(n))
        out[n] = (a, reports)
    return out


def _cases(port, n, name):
    return [r["cases"][name] for r in port[n][1]]


def _same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,form", MP2_FORMS)
def test_mp2_rings_are_bitwise_the_blocking_path(port, name, form):
    """At mp 2 the ring's sum is one addition: output and every gradient
    bitwise the blocking path's, on each rank (the plans run unchunked at
    mp 2, so they have no chunked case)."""
    for ring, blk in zip(_cases(port, 2, f"{name}:{form}"),
                         _cases(port, 2, f"{name}:blocking")):
        _same(ring, blk, name)


@pytest.mark.parametrize("name,form", [
    ("rag", "ring"), ("rag", "ring:chunks4"), ("rag", "plan"), ("rg", "ring"),
    ("rg", "ring:chunks4")])
def test_gather_rings_are_bitwise_at_mp4(port, name, form):
    for ring, blk in zip(_cases(port, 4, f"{name}:{form}"),
                         _cases(port, 4, f"{name}:blocking")):
        _same(ring, blk, name)


@pytest.mark.parametrize("name", ["rar:ring", "rar:ring:chunks4", "rar:plan",
                                  "rr:ring", "rr:ring:chunks4", "ffn:ring"])
def test_reduce_rings_at_mp4_within_f32(port, name):
    """mp 4 re-associates the ring's sum: within f32 tolerance of the
    blocking path, and not always bitwise (the ring is really another
    order)."""
    for ring, blk in zip(_cases(port, 4, name),
                         _cases(port, 4, name.split(":")[0] + ":blocking")):
        assert ring.keys() == blk.keys()
        for k in ring:
            np.testing.assert_allclose(ring[k], blk[k], rtol=RTOL,
                                       atol=ATOL, err_msg=(name, k))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["rar", "rag", "rr", "rg"])
def test_chunking_is_bitwise_neutral(port, n, name):
    for ch, un in zip(_cases(port, n, f"{name}:ring:chunks4"),
                      _cases(port, n, f"{name}:ring")):
        _same(ch, un, name)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_hop_brings_the_previous_ranks_tensor(port, n):
    for case in _cases(port, n, "hop"):
        np.testing.assert_array_equal(case["out"], case["want"])


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_embedding_ring_is_exact(port, n):
    """Each row is non-zero on one rank: the ring sum is the full table's
    lookup bit for bit, as the blocking all-reduce is."""
    a = port[n][0]
    want = a["table"][a["ids"]]
    for ring, blk in zip(_cases(port, n, "embed:ring"),
                         _cases(port, n, "embed:blocking")):
        np.testing.assert_array_equal(ring["out"], want)
        np.testing.assert_array_equal(blk["out"], want)
        np.testing.assert_array_equal(ring["dtable"], blk["dtable"])


@pytest.mark.parametrize("n", [2, 4])
def test_parallel_cross_entropy(port, n):
    """The picked logit, summed over the ranks' masked picks by the
    gather ring, is the label's logit exactly; the plan's and the
    blocking vocabulary-parallel losses agree with a float64 cross
    entropy and with each other, gradients too."""
    a = port[n][0]
    logits, labels = a["logits"].astype(np.float64), a["labels"]
    want_pick = a["logits"][np.arange(T), labels]
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[:, 0]
    soft = np.exp(logits - lse[:, None])
    soft[np.arange(T), labels] -= 1
    dlogits = soft * a["g_ce"][:, None]
    vs = VOCAB // n
    for r, (pick, ring, blk) in enumerate(zip(
            _cases(port, n, "picked"), _cases(port, n, "ce:ring"),
            _cases(port, n, "ce:blocking"))):
        np.testing.assert_array_equal(pick["out"], want_pick)
        for got in (ring, blk):
            np.testing.assert_allclose(got["out"], lse - want_pick,
                                       rtol=1e-6, atol=1e-5)
            np.testing.assert_allclose(got["dlogits"],
                                       dlogits[:, r * vs:(r + 1) * vs],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ring["out"], blk["out"], rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["rar:ring", "rag:ring", "rr:ring",
                                  "rg:ring", "ffn:ring", "embed:ring",
                                  "ce:ring"])
def test_replicated_outputs_agree_across_ranks(port, n, name):
    outs = [c["out"] for c in _cases(port, n, name)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


# ---------------------------------------------------------------------------
# JAX's islands on the same operands
# ---------------------------------------------------------------------------

def _grads(f, g, *args):
    def loss(*xs):
        return jnp.sum(f(*xs) * g)
    out = f(*args)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(d) for d in grads]


def _island(fn, mesh, in_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=P(),
                     axis_names=frozenset(mesh.axis_names), check_vma=False)


def _jax_cases(a, n):
    """{case: (out, [grads])} of JAX's islands on the operands ``a``."""
    a = {k: jnp.asarray(v) for k, v in a.items()}
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("mp",))
    res = {}
    for c in (1, 4):
        tag = "" if c == 1 else ":chunks4"
        rar = _island(functools.partial(jcm.ring_allreduce_matmul, n=n,
                                        axis_name="mp", nchunks=c),
                      mesh, (P(None, "mp"), P("mp", None)))
        res["rar:ring" + tag] = _grads(jax.jit(rar), a["g_rar"],
                                       a["x_row"], a["w_row"])
        rag = _island(functools.partial(jcm.ring_allgather_matmul, n=n,
                                        axis_name="mp", nchunks=c),
                      mesh, (P(), P(None, "mp")))
        res["rag:ring" + tag] = _grads(jax.jit(rag), a["g_rag"],
                                       a["x_col"], a["w_col"])
        rr = _island(lambda x, c=c: jcm.ring_allreduce(x[0], n, "mp", c),
                     mesh, (P("mp"),))
        res["rr:ring" + tag] = _grads(jax.jit(rr), a["g_rr"], a["x_rr"])
        rg = _island(lambda x, c=c: jcm.ring_allgather(x[0], n, "mp", c),
                     mesh, (P("mp"),))
        res["rg:ring" + tag] = _grads(jax.jit(rg), a["g_rg"], a["x_rr"])
    plan = jcm.plan_row_parallel((T, K * n), (K * n, OUT), mesh)
    res["rar:plan"] = _grads(jax.jit(plan), a["g_rar"], a["x_row"],
                             a["w_row"])
    plan = jcm.plan_column_parallel((T, K), (K, OUT * n), mesh)
    res["rag:plan"] = _grads(jax.jit(plan), a["g_rag"], a["x_col"],
                             a["w_col"])
    b, s, h, i = FFN
    plan = jcm.plan_fused_ffn((b, s, h), (h, i), (i, h), mesh, n_cols=2,
                              activation=jcm.swiglu)
    assert plan is not None
    res["ffn:ring"] = _grads(
        jax.jit(lambda x, g_, u, d: plan(x, (g_, u), d)), a["g_ffn"],
        a["ffn_x"], a["ffn_gate"], a["ffn_up"], a["ffn_down"])
    plan = jcm.plan_vocab_parallel_embedding((b, s), (VOCAB, EMB_H), mesh)
    res["embed:ring"] = _grads(jax.jit(lambda t: plan(a["ids"], t)),
                               a["g_embed"], a["table"])
    plan = jcm.plan_parallel_cross_entropy((T, VOCAB), mesh)
    res["ce:ring"] = _grads(jax.jit(lambda l_: plan(l_, a["labels"])),
                            a["g_ce"], a["logits"])
    return res


@pytest.fixture(scope="module")
def jax_runs(port, monkeypatch_module):
    """{n: {case: (out, [grads of the global operands])}} from JAX."""
    monkeypatch_module.setenv("PADDLE_TPU_TP_OVERLAP_MIN_CHUNK", MIN_CHUNK)
    jcm.clear_plan_cache()
    try:
        return {n: _jax_cases(port[n][0], n) for n in (2, 4)}
    finally:
        jcm.clear_plan_cache()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


# (operand names in order, the dim each is split over mp, None: whole on
# every rank; "rank": the rank's slab of a stacked operand)
_OPERANDS = {
    "rar": (("x", 1), ("w", 0)), "rag": (("x", None), ("w", 1)),
    "rr": (("x", "rank"),), "rg": (("x", "rank"),),
    "ffn": (("x", None), ("gate", 1), ("up", 1), ("down", 0)),
    "embed": (("table", 0),), "ce": (("logits", 1),),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(
    ["rar:ring", "rar:ring:chunks4", "rar:plan", "rag:ring",
     "rag:ring:chunks4", "rag:plan", "rr:ring", "rr:ring:chunks4", "rg:ring", "rg:ring:chunks4",
     "ffn:ring", "embed:ring", "ce:ring"]))
def test_rings_match_jax_islands(port, jax_runs, n, name):
    """Every rank's output, and its part of each gradient, within f32
    tolerance of JAX's island on the same global operands (JAX's
    gradients are of the global operands; a replicated operand's is the
    whole one, as the port's after ``copy_to_mp``)."""
    out, grads = jax_runs[n][name]
    for r, case in enumerate(_cases(port, n, name)):
        np.testing.assert_allclose(case["out"], out, rtol=RTOL, atol=ATOL)
        for (arg, dim), g in zip(_OPERANDS[name.split(":")[0]], grads):
            if dim == "rank":
                g = g[r]
            elif dim is not None:
                k = g.shape[dim] // n
                g = np.take(g, range(r * k, (r + 1) * k), axis=dim)
            np.testing.assert_allclose(case[f"d{arg}"], g, rtol=RTOL,
                                       atol=ATOL, err_msg=(name, r, arg))


def test_spawned_ranks_import_no_jax(port):
    for n, (_, reports) in port.items():
        for r in reports:
            assert r["jax_modules"] == [], (n, r["jax_modules"])
