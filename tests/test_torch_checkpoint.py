"""The port's checkpoint save/load (paddle_tpu_torch.distributed.checkpoint)
against paddle_tpu's, on the CPU.

The array payload is the port's own (one raw file a leaf and an index; no
orbax), so neither side reads the other's arrays. What is held equal:

- ``manifest.json`` (``step``, ``leaf_checksums``, ``n_leaves``) and
  ``sharding_meta.json``, byte for byte, for the same tiny Llama train
  state (bf16 params, f32 AdamW moments after one update, the 0-d f32
  ``t``, an int ``step``) carried across by ``params_from_numpy``;
- every fill rule of ``load_state_dict`` (partial keys, adoption,
  namedtuples, a sequence length mismatch, the ``.old`` fallback): the
  same saves and loads on both sides give the same values, exactly;
- the snapshot is taken when ``save_state_dict`` returns: a later
  in-place update (the port's AdamW writes params and moments in place)
  does not reach the checkpoint.
"""
import collections
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import save_load as jsl
from paddle_tpu.models import llama as jl

from paddle_tpu_torch.distributed.checkpoint import save_load as sl
from paddle_tpu_torch.models import llama as tl


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(np_tree):
    """A numpy tree as port tensors on the CPU (bf16 kept as bf16)."""
    return tl.params_from_numpy(np_tree, "cpu")


def _flat(tree, prefix=""):
    """{path: numpy} of a tree of tensors/arrays; bf16 as float32."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    if isinstance(tree, paddle.Tensor):
        tree = tree._data
    return {prefix: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def jax_state():
    """A tiny Llama train state in JAX, after one AdamW update: bf16
    params, f32 moments, 0-d f32 t, and an int step."""
    cfg = jl.llama_tiny(vocab=96, hidden=64, layers=2, heads=4, kv_heads=2,
                        inter=128, seq=256)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                    jl.init_llama_params(cfg, seed=0))
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape) * 1e-2, a.dtype), params)
    params, opt = jl._adamw_update(params, grads, jl._adamw_init(params),
                                   3e-4)
    return {"params": params, "opt": opt, "step": 3}


def _port_state(jax_state):
    return {"params": _port(_np(jax_state["params"])),
            "opt": _port(_np(jax_state["opt"])), "step": jax_state["step"]}


@pytest.fixture(scope="module")
def saved(jax_state, tmp_path_factory):
    """The train state saved once by each side, with a manifest."""
    root = tmp_path_factory.mktemp("ck")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jsl.save_state_dict(jax_state, jdir, manifest={"step": 3})
    state = _port_state(jax_state)
    sl.save_state_dict(state, tdir, manifest={"step": 3})
    return jdir, tdir, state


def test_sidecars_and_checksums_match_jax(jax_state, saved):
    jdir, tdir, state = saved
    for name in ("manifest.json", "sharding_meta.json"):
        with open(os.path.join(jdir, name)) as f:
            want = f.read()
        with open(os.path.join(tdir, name)) as f:
            assert f.read() == want, name
    man = sl.load_manifest(tdir)
    assert man == jsl.load_manifest(jdir)
    n = len(jax.tree_util.tree_leaves(jax_state))
    assert man["n_leaves"] == n == len(man["leaf_checksums"])
    assert sl.load_sharding_meta(tdir) == jsl.load_sharding_meta(jdir) == \
        {"leaf_shardings": [None] * n}
    # the same list from the live tensors, and from JAX's own snapshot
    assert sl.leaf_checksums(state) == man["leaf_checksums"] == \
        jsl.leaf_checksums(jsl._to_arrays(jax_state))
    # bf16 leaves are named as numpy names them, by their bits
    assert {leaf.dtype for leaf in sl.read_tree(tdir)["params"]["layers"]
            .values()} == {"bfloat16"}


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def test_roundtrip_keeps_bits_identity_and_storage(jax_state, saved):
    """A restore copies into the template's own tensors (same objects,
    same data_ptr), bf16 bits kept; JAX's restore gives the same values."""
    jdir, tdir, state = saved
    tmpl = {"params": _zeros_like(state["params"]),
            "opt": _zeros_like(state["opt"]), "step": 0}
    before = {k: (id(t), t.data_ptr(), t.dtype)
              for k, t in _leaves_by_path(tmpl).items()}
    sl.load_state_dict(tmpl, tdir)
    after = _leaves_by_path(tmpl)
    assert set(after) == set(before)
    for k, t in after.items():
        assert (id(t), t.data_ptr(), t.dtype) == before[k], k
    live = _leaves_by_path(state)
    for k in live:
        assert torch.equal(after[k], live[k]), k
    assert isinstance(tmpl["step"], np.ndarray) and int(tmpl["step"]) == 3
    jt = {"params": jax.tree_util.tree_map(jnp.zeros_like,
                                           jax_state["params"]),
          "opt": jax.tree_util.tree_map(jnp.zeros_like, jax_state["opt"]),
          "step": 0}
    jsl.load_state_dict(jt, jdir)
    want = _flat({"params": jt["params"], "opt": jt["opt"]})
    got = _flat({"params": tmpl["params"], "opt": tmpl["opt"]})
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert type(jt["step"]) is type(tmpl["step"]) and \
        int(jt["step"]) == int(tmpl["step"])


def _leaves_by_path(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves_by_path(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def test_snapshot_isolated_from_in_place_adamw(jax_state, tmp_path):
    """The port's AdamW writes params and moments in place: an update
    launched right after an async save returns must not reach the
    checkpoint."""
    state = _port_state(jax_state)
    want = sl.leaf_checksums(state)
    h = sl.save_state_dict(state, str(tmp_path / "ck"), async_save=True,
                           manifest={"step": 3})
    grads = {k: (torch.full_like(v, 0.5) if not isinstance(v, dict) else
                 {kk: torch.full_like(vv, 0.5) for kk, vv in v.items()})
             for k, v in state["params"].items()}
    tl._adamw_update(state["params"], grads, state["opt"], 1e-2)
    assert sl.leaf_checksums(state) != want
    h.wait()
    assert sl.load_manifest(str(tmp_path / "ck"))["leaf_checksums"] == want
    tmpl = _port_state(jax_state)
    tmpl["step"] = 0
    sl.load_state_dict(tmpl, str(tmp_path / "ck"))
    assert sl.leaf_checksums(tmpl) == want


def test_async_snapshot_isolated_like_jax(tmp_path):
    sd = {"w": torch.ones(512 * 512)}
    h = sl.save_state_dict(sd, str(tmp_path / "ck"), async_save=True)
    sd["w"][:] = 999.0   # a simulated next optimizer step
    h.wait()
    assert h.done()
    target = {"w": torch.zeros(512 * 512)}
    sl.load_state_dict(target, str(tmp_path / "ck"))
    assert torch.equal(target["w"], torch.ones(512 * 512))


def _both(tmp_path, saved_np, target_np, name):
    """Save ``saved_np`` and load it into ``target_np`` on each side (the
    port adopting onto the CPU); returns (port target, JAX target)."""
    jd, td = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    jsl.save_state_dict(jax.tree_util.tree_map(
        lambda a: paddle.to_tensor(a), saved_np), jd)
    sl.save_state_dict(jax.tree_util.tree_map(torch.from_numpy, saved_np),
                       td)
    tt = jax.tree_util.tree_map(torch.from_numpy, target_np)
    jt = jax.tree_util.tree_map(lambda a: paddle.to_tensor(a), target_np)
    sl.load_state_dict(tt, td, device="cpu")
    jsl.load_state_dict(jt, jd)
    return tt, jt


def test_partial_keys_like_jax(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(2, 2).astype(np.float32)
    tt, jt = _both(tmp_path, {"w": w},
                   {"w": np.zeros((2, 2), np.float32),
                    "extra": np.zeros(3, np.float32)}, "partial")
    assert sorted(tt) == sorted(jt) == ["extra", "w"]
    for k in tt:
        np.testing.assert_array_equal(tt[k].numpy(), jt[k].numpy())
    np.testing.assert_array_equal(tt["w"].numpy(), w)
    np.testing.assert_array_equal(tt["extra"].numpy(), 0.0)


def test_adoption_like_jax(tmp_path):
    """Saved keys the target lacks are adopted whole, as owned tensors on
    the device the call names; device=None means the card."""
    rng = np.random.RandomState(1)
    saved = {"w": rng.randn(3).astype(np.float32),
             "opt": {"m": rng.randn(2, 3).astype(np.float32),
                     "seq": [rng.randn(2).astype(np.float32),
                             np.arange(4, dtype=np.int32)]}}
    tt, jt = _both(tmp_path, saved, {"w": np.zeros(3, np.float32)}, "adopt")
    assert tt["opt"]["m"].device.type == "cpu"
    got, want = _flat({"w": tt["w"], "opt": {"m": tt["opt"]["m"]}}), \
        _flat({"w": jt["w"], "opt": {"m": jt["opt"]["m"]}})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(tt["opt"]["seq"]) == len(jt["opt"]["seq"]) == 2
    for a, b in zip(tt["opt"]["seq"], jt["opt"]["seq"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b._data))
        assert a.dtype == (torch.int32 if b._data.dtype == jnp.int32
                           else torch.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sl.load_state_dict({"w": torch.zeros(3)},
                               str(tmp_path / "t_adopt"))
    # nothing to adopt: the leaves' own device, no device needed
    sl.load_state_dict({"w": torch.zeros(3), "opt": {
        "m": torch.zeros(2, 3), "seq": [torch.zeros(2),
                                        torch.zeros(4, dtype=torch.int32)]}},
        str(tmp_path / "t_adopt"))


def test_namedtuple_and_length_mismatch_like_jax(tmp_path):
    Pair = collections.namedtuple("Pair", ["a", "b"])
    saved = {"p": [np.ones(2, np.float32), np.zeros(2, np.float32)]}
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    sl.save_state_dict({"p": [torch.ones(2), torch.zeros(2)]}, td)
    jsl.save_state_dict({"p": [paddle.ones([2]), paddle.zeros([2])]}, jd)
    tt = {"p": Pair(torch.zeros(2), torch.full((2,), 7.0))}
    jt = {"p": Pair(paddle.zeros([2]), paddle.full([2], 7.0))}
    sl.load_state_dict(tt, td)
    jsl.load_state_dict(jt, jd)
    assert isinstance(tt["p"], Pair) and isinstance(jt["p"], Pair)
    for i in range(2):
        np.testing.assert_array_equal(tt["p"][i].numpy(), jt["p"][i].numpy())
        np.testing.assert_array_equal(tt["p"][i].numpy(), saved["p"][i])
    with pytest.raises(ValueError, match="length mismatch"):
        sl.load_state_dict({"p": [torch.zeros(2)]}, td)
    with pytest.raises(ValueError, match="length mismatch"):
        jsl.load_state_dict({"p": [paddle.zeros([2])]}, jd)


def test_shape_mismatch_raises_naming_the_leaf(tmp_path):
    """copy_ would broadcast a [4] leaf into a [2, 4] tensor; the port
    refuses instead (JAX replaces the leaf by the saved array)."""
    p = str(tmp_path / "ck")
    sl.save_state_dict({"a": {"w": torch.ones(4)}}, p)
    with pytest.raises(ValueError, match=r"a\.w.*\(4,\).*\(2, 4\)"):
        sl.load_state_dict({"a": {"w": torch.zeros(2, 4)}}, p)


def test_crash_between_publish_renames_resumable(tmp_path):
    """A kill after the old checkpoint was moved aside but before the new
    one was renamed in: load falls back to the '.old' copy, as in JAX."""
    for side, save, load, mk in (
            ("port", sl.save_state_dict, sl.load_state_dict,
             lambda v: torch.full((2,), v)),
            ("jax", jsl.save_state_dict, jsl.load_state_dict,
             lambda v: paddle.full([2], v))):
        p = str(tmp_path / side)
        save({"w": mk(1.0)}, p)
        save({"w": mk(2.0)}, p)
        shutil.move(p, p + ".tmp-crashed")
        shutil.move(p + ".tmp-crashed", p + ".old")
        target = {"w": mk(0.0)}
        load(target, p)
        np.testing.assert_array_equal(np.asarray(target["w"].numpy()),
                                      [2.0, 2.0])
    assert sl.load_sharding_meta(str(tmp_path / "port")) == \
        {"leaf_shardings": [None]}


def test_failed_async_save_does_not_poison_next(tmp_path):
    sd = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = str(tmp_path / "ckpt")
    h = sl.save_state_dict(sd, path, async_save=True)
    h._thread.join()
    # a predecessor that died with an error but is still registered
    h._error = RuntimeError("injected poison")
    with sl._pending_lock:
        sl._pending[os.path.abspath(path)] = h
    sl.save_state_dict(sd, path, async_save=False)  # neither raise nor spin
    tgt = {"w": torch.zeros(2, 3)}
    sl.load_state_dict(tgt, path)
    assert torch.equal(tgt["w"], sd["w"])


def test_save_snapshot_does_not_alias_the_live_tensor():
    """The snapshot-aliasing bug, the torch way: on the CPU ``t.cpu()``,
    ``t.detach()`` and ``t.numpy()`` are the live storage, which the
    in-place AdamW rewrites under the async writer. The snapshot owns its
    memory."""
    t = torch.arange(8.0)
    assert t.cpu() is t and np.shares_memory(t.numpy(), t.detach().numpy())
    snap = sl._snapshot(t)
    assert not np.shares_memory(snap.array, t.numpy())
    b = torch.arange(8.0).to(torch.bfloat16)
    sb = sl._snapshot(b)
    assert sb.dtype == "bfloat16" and sb.array.dtype == np.int16
    assert not np.shares_memory(sb.array, b.view(torch.int16).numpy())


def test_restore_conversion_does_not_borrow_host_buffers():
    """The mirror bug: ``torch.from_numpy`` of a buffer someone else owns
    (an mmap, ``np.frombuffer``) is zero-copy. The restore conversion
    always makes a tensor that owns its memory."""
    raw = np.zeros(1024 + 16, dtype=np.float32)
    off = (-raw.ctypes.data) % 64 // 4
    aligned = raw[off:off + 1024]
    assert aligned.ctypes.data % 64 == 0
    borrowed = torch.from_numpy(aligned)
    assert np.shares_memory(borrowed.numpy(), aligned)   # the precondition
    out = sl._from_host(borrowed, torch.float32, "cpu")
    assert not np.shares_memory(out.numpy(), aligned)
    # a leaf read from disk is an owned buffer too
    view = np.frombuffer(bytearray(aligned.tobytes()), dtype=np.float32)
    assert not np.shares_memory(sl._from_host(torch.from_numpy(view),
                                              device="cpu").numpy(), view)


def test_leaf_checksums_match_jax_on_arrays_and_scalars():
    rng = np.random.RandomState(2)
    tree = {"b": rng.randn(3, 5).astype(np.float32),
            "a": [np.arange(4, dtype=np.int32), 7, 2.5, True],
            "c": {"z": np.zeros((), np.float32), "y": None}}
    assert sl.leaf_checksums(tree) == jsl.leaf_checksums(tree)
    as_torch = {"b": torch.from_numpy(tree["b"]),
                "a": [torch.from_numpy(tree["a"][0]), 7, 2.5, True],
                "c": {"z": torch.zeros(()), "y": None}}
    assert sl.leaf_checksums(as_torch) == jsl.leaf_checksums(tree)
