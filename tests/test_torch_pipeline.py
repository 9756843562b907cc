"""Port parity: paddle_tpu_torch.parallel.pipeline over gloo ranks (one
process a stage, on the CPU) against paddle_tpu.parallel.pipeline inside
shard_map over 2 and 4 of JAX's virtual CPU devices.

The setups are JAX's tests': ``test_overlap_parity.py``'s
``_pp_loss_grads`` (a stage tanh(h @ w + b), H 16, B 2M rows, the loss
``last_stage_value`` of sum(out^2), remat on) at (S, M) = (2, 4) and (4,
4), blocking and overlapped, and ``test_pipeline_interleave.py``'s (a
chunk tanh(h @ w), S 4, V 2, M 8, the round-robin layout). Each rank
returns the loss, its stage's gradients, the last stage's outputs and
its counters:

- the loss within 1e-6 of JAX's, relative; each gradient and the
  outputs within 1e-6 of their largest element; the overlapped schedule
  bitwise the blocking one in the port (JAX's holds the same, bitwise,
  in ``test_pp_overlap_bitwise``);
- the ``pp.`` counters equal JAX's; each rank makes T hops forward and T
  back (its ``comm.ppermute.pp`` calls and bytes), T = M + S - 1 or
  M + 2(S - 1), so the ranks' point-to-point calls pair up;
- the interleave's outputs and gradients as close to JAX's, and its
  M % S refusal; ``microbatch``, ``stack_stage_params`` and
  ``last_stage_value`` at one stage against JAX's; the loss built by
  ``build_pipeline_loss_fn`` bitwise the pipeline it composes.

One spawn of 2 ranks and one of 4, each within ``JOIN_S`` seconds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu._compat import shard_map
from paddle_tpu.observability import trace as jtrace
from paddle_tpu.parallel import pipeline as jpl

from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.parallel import pipeline as tpl
from paddle_tpu_torch.testing import dist as td

H, JOIN_S = 16, 120
# name -> (S, M, overlap); the interleave runs at S 4, V 2, M 8
CASES = {f"s{s}_m{m}_{'overlap' if o else 'blocking'}": (s, m, o)
         for s, m in ((2, 4), (4, 4)) for o in (False, True)}
ENV_CASE = "s2_m4_env"          # overlap from PADDLE_TPU_TORCH_PP_OVERLAP
LOSS_FN_CASE = "s2_m4_loss_fn"  # through build_pipeline_loss_fn
IV = dict(S=4, V=2, M=8)


def _inputs():
    """{name: arrays} of every case, as JAX's tests make them."""
    out = {}
    for name, (s, m, _) in CASES.items():
        rng = np.random.RandomState(0)
        w, b = [], []
        for _ in range(s):
            w.append((rng.randn(H, H) * 0.3).astype(np.float32))
            b.append((rng.randn(H) * 0.1).astype(np.float32))
        out[name] = {"w": np.stack(w), "b": np.stack(b),
                     "x": rng.randn(m * 2, H).astype(np.float32)}
    out[ENV_CASE] = out[LOSS_FN_CASE] = out["s2_m4_overlap"]
    rng = np.random.RandomState(2)
    chunks = [(rng.randn(H, H) * 0.3).astype(np.float32)
              for _ in range(IV["S"] * IV["V"])]
    # rank s holds slots v: chunk v S + s
    out["interleave"] = {
        "w": np.stack([chunks[v * IV["S"] + s] for s in range(IV["S"])
                       for v in range(IV["V"])]),
        "x": np.random.RandomState(3).randn(IV["M"] * 4, H).astype(
            np.float32)}
    return out


def _jax_case(a, s, m, overlap):
    mesh = Mesh(np.array(jax.devices("cpu")[:s]), ("pp",))
    jtrace.reset_counters()
    pipe = jpl.pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                              s, m, "pp", remat=True, overlap_p2p=overlap)
    counters = {k: v for k, v in jtrace.counters().items()
                if k.startswith("pp.")}

    def island(params, xm):
        out = pipe(params, xm)
        return jpl.last_stage_value(jnp.sum(out ** 2), s, "pp"), \
            jax.lax.psum(out, "pp")
    f = shard_map(island, mesh=mesh, in_specs=(P("pp"), P()),
                  out_specs=(P(), P()), axis_names=frozenset(["pp"]),
                  check_vma=False)
    params = {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}
    x_mb = jpl.microbatch(jnp.asarray(a["x"]), m)
    (loss, outputs), grads = jax.jit(jax.value_and_grad(
        lambda p: f(p, x_mb), has_aux=True))(params)
    return {"loss": np.asarray(loss), "outputs": np.asarray(outputs),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "counters": counters}


def _jax_interleave(a):
    s, v, m = IV["S"], IV["V"], IV["M"]
    mesh = Mesh(np.array(jax.devices("cpu")[:s]), ("pp",))
    pipe = jpl.pipeline_apply_interleave(lambda w, h: jnp.tanh(h @ w), s,
                                         v, m, "pp")

    def island(params, xm):
        out = pipe(params, xm)
        return jpl.last_stage_value(jnp.sum(out ** 2), s, "pp"), \
            jax.lax.psum(out, "pp")
    f = shard_map(island, mesh=mesh, in_specs=(P("pp"), P()),
                  out_specs=(P(), P()), axis_names=frozenset(["pp"]),
                  check_vma=False)
    x_mb = jpl.microbatch(jnp.asarray(a["x"]), m)
    (loss, outputs), grads = jax.jit(jax.value_and_grad(
        lambda p: f(p, x_mb), has_aux=True))(jnp.asarray(a["w"]))
    return {"loss": np.asarray(loss), "outputs": np.asarray(outputs),
            "grads": {"w": np.asarray(grads)}}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_runs(inputs):
    out = {name: _jax_case(inputs[name], *case)
           for name, case in CASES.items()}
    out["interleave"] = _jax_interleave(inputs["interleave"])
    return out


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """{world: every rank's report}."""
    tmp = tmp_path_factory.mktemp("pipeline")
    path = str(tmp / "inputs.npz")
    np.savez(path, **{f"{c}/{k}": v for c, arrays in inputs.items()
                      for k, v in arrays.items()})
    out = {}
    for world in (2, 4):
        cases = [dict(name=n, microbatches=m, overlap=o)
                 for n, (s, m, o) in CASES.items() if s == world]
        if world == 2:
            cases.append(dict(name=ENV_CASE, microbatches=4, overlap=None,
                              env={tpl.ENV_PP_OVERLAP: "1"}))
            cases.append(dict(name=LOSS_FN_CASE, microbatches=4,
                              overlap=True, composed=True))
        else:
            cases.append(dict(name="interleave", microbatches=IV["M"],
                              virtual=IV["V"]))
        out[world] = td.spawn(td.pipeline_job, world,
                              ({"inputs": path, "cases": cases},),
                              timeout=JOIN_S, store_dir=str(tmp))
    return out


def _ranks(port_runs, name):
    world = IV["S"] if name == "interleave" else (
        2 if name in (ENV_CASE, LOSS_FN_CASE) else CASES[name][0])
    return [r["cases"][name] for r in port_runs[world]]


def _close(got, want, what):
    """Within 1e-6 of the array's largest element: the two sum the
    matrix products in another order (the s4 runs' gradients sit 4.4e-7
    of it apart)."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", list(CASES) + ["interleave"])
def test_loss_and_grads_match_jax(jax_runs, port_runs, name):
    want = jax_runs[name]
    ranks = _ranks(port_runs, name)
    for r in ranks:         # the same loss on every stage
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-6)
    for key, g in want["grads"].items():
        got = np.concatenate([r["grads"][key] for r in ranks])
        assert got.shape == g.shape
        _close(got, g, key)
    _close(ranks[-1]["outputs"], want["outputs"], "outputs")
    for r in ranks[:-1]:    # zeros off the last stage, as JAX's
        assert not r["outputs"].any()


@pytest.mark.parametrize("s,m", [(2, 4), (4, 4)])
def test_overlap_is_bitwise_blocking(port_runs, s, m):
    blk = _ranks(port_runs, f"s{s}_m{m}_blocking")
    ovl = _ranks(port_runs, f"s{s}_m{m}_overlap")
    for a, b in zip(blk, ovl):
        assert np.array_equal(a["loss"], b["loss"])
        assert np.array_equal(a["outputs"], b["outputs"])
        for k in a["grads"]:
            assert np.array_equal(a["grads"][k], b["grads"][k]), k


def test_overlap_follows_the_env(port_runs):
    """overlap_p2p None reads PADDLE_TPU_TORCH_PP_OVERLAP: the run is the
    explicit overlapped one, bit for bit, with its tick count."""
    env = _ranks(port_runs, ENV_CASE)
    ovl = _ranks(port_runs, "s2_m4_overlap")
    for a, b in zip(env, ovl):
        assert a["counters"] == b["counters"]
        assert np.array_equal(a["loss"], b["loss"])
        for k in a["grads"]:
            assert np.array_equal(a["grads"][k], b["grads"][k]), k


def test_the_loss_builder_is_the_pipeline_it_composes(port_runs):
    """build_pipeline_loss_fn over an embed_fn that microbatches the
    batch and a head that sums squares: the loss and gradients of
    pipeline_apply and last_stage_value, bit for bit."""
    got = _ranks(port_runs, LOSS_FN_CASE)
    ovl = _ranks(port_runs, "s2_m4_overlap")
    for a, b in zip(got, ovl):
        assert np.array_equal(a["loss"], b["loss"])
        for k in b["grads"]:
            assert np.array_equal(a["grads"][k], b["grads"][k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_counters_equal_jax_and_hops_pair_up(jax_runs, port_runs, name):
    s, m, overlap = CASES[name]
    ticks = m + (2 if overlap else 1) * (s - 1)
    hop = 2 * H * 4                     # one microbatch [2, H] in f32
    for r in _ranks(port_runs, name):
        c = r["counters"]
        assert {k: v for k, v in c.items() if k.startswith("pp.")} == \
            jax_runs[name]["counters"]
        assert c["pp.ticks"] == ticks
        assert c["comm.ppermute.pp.calls"] == 2 * ticks
        assert c["comm.ppermute.pp.bytes"] == 2 * ticks * hop


def test_interleave_refuses_microbatches_the_stages_do_not_divide():
    msg = r"num_microbatches \(6\) divisible by num_stages \(4\)"
    with pytest.raises(ValueError, match=msg):
        jpl.pipeline_apply_interleave(lambda w, h: h, 4, 2, 6, "pp")
    with pytest.raises(ValueError, match=msg):
        tpl.pipeline_apply_interleave(lambda w, h: h, 4, 2, 6,
                                      Group("pp", 4))


def test_microbatch_stack_and_one_stage_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(8, 3, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tpl.microbatch(torch.from_numpy(x), 4).numpy(),
        np.asarray(jpl.microbatch(jnp.asarray(x), 4)))
    with pytest.raises(ValueError, match="8 rows"):
        tpl.microbatch(torch.from_numpy(x), 3)
    per = [{"w": rng.randn(2, 2).astype(np.float32),
            "n": {"b": rng.randn(2).astype(np.float32)}} for _ in range(3)]
    got = tpl.stack_stage_params(
        [jax.tree_util.tree_map(torch.from_numpy, p) for p in per])
    want = jpl.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in per])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"]["b"].numpy(),
                                  np.asarray(want["n"]["b"]))
    v = torch.tensor(2.5)
    assert tpl.last_stage_value(v, 1, Group("pp", 1)) is v
    assert jpl.last_stage_value(2.5, 1, "pp") == 2.5


def test_one_stage_runs_every_microbatch_without_a_hop():
    """S = 1: T = M ticks, the outputs are the stage on each microbatch."""
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
    w = torch.randn(1, 4, 4, generator=torch.Generator().manual_seed(1))
    out = tpl.pipeline_apply(lambda p, h: h @ p, 1, 3, Group("pp", 1),
                             remat=False)(w, tpl.microbatch(x, 3))
    torch.testing.assert_close(out.reshape(6, 4), x @ w[0], rtol=0, atol=0)


def test_spawned_ranks_import_no_jax(port_runs):
    for world, ranks in port_runs.items():
        for r in ranks:
            assert r["jax_modules"] == [], (world, r["jax_modules"])
