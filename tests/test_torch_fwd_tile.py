"""The dense flash forward's key tile: the rounding schedule that the bf16
wgmma kernel (rows 14 and 13) shares with ``flash_fwd_plain``.

The forward rounds P to the input dtype against the running row max after
every tile of keys, so the tile is part of its arithmetic. The bf16
kernel loads 128-key stages but runs its softmax and P.V per 64-key half,
so its schedule is the 64-key walk of the plain version (``BLOCK_K``),
which the card check holds it to. Here, on the CPU:

- the plain forward at that tile against JAX's ``_flash_fwd`` (Pallas in
  interpret mode, jitted through a fresh closure) at the same key tile in
  JAX's online softmax mode, the recurrence the port implements, on tiny
  bf16 shapes (causal and not, a ragged S, Sq != Sk, kv_len < Sk, D 64
  and 128) under chip_smoke's bf16 rule (``flash_close``: elementwise
  2^-6 of |ref| + row max + rms, relative Frobenius 2^-10); the measured
  gap (a summation order's, about 1e-5) is printed and named in the
  failure message. JAX's default tile-0-anchored mode, or another key
  tile, rounds P against other maxima: 1.4e-3 to 2.1e-3 apart at S 200
  not causal;
- CPU tensors through ``flash_fwd`` take exactly that walk, f32 too;
- a 128-key walk lies outside 2^-10 of the 64-key walk at a shape the
  kernels run (S 1024, D 64), which is why the kernel keeps 64-key
  softmax tiles (tools/fwd_tile_gap.py measures more shapes).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import FLASH_TOL, flash_close
from paddle_tpu.ops import _common
from paddle_tpu.ops import flash_attention as jfa

from paddle_tpu_torch.ops import flash_attention as fa

BF16_REL, BF16_FROB = FLASH_TOL[torch.bfloat16][0]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv(jfa.ENV_FLASH_SOFTMAX, "online")
    with _common.interpret_mode(True):
        yield


def _inputs(bh, sq, sk, d, dtype, seed):
    """q pre-scaled as the kernels take it, k and v; numpy-seeded."""
    rng = np.random.RandomState(seed)
    qs = rng.randn(bh, sq, d) * (fa.LOG2E / d ** 0.5)
    k, v = rng.randn(bh, sk, d), rng.randn(bh, sk, d)
    return [torch.from_numpy(x.astype(np.float32)).to(dtype)
            for x in (qs, k, v)]


def _jax_fwd(qs, k, v, causal, block_k):
    """JAX's _flash_fwd on q already pre-scaled (scale None) over
    ``block_k``-key tiles, jitted through a new closure so that it is
    traced anew (JAX reads its softmax mode at trace time)."""
    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    o, lse = jax.jit(lambda a, b, c: jfa._flash_fwd(
        a, b, c, causal, None, 128, block_k))(j(qs), j(k), j(v))
    return (torch.from_numpy(np.array(o.astype(jnp.float32))),
            torch.from_numpy(np.array(lse)))


# (Sq, Sk, D, causal, kv_len or None for all keys)
CASES = [(200, 200, 128, False, None),
         (96, 224, 128, True, None),
         (224, 96, 64, True, None),
         (160, 256, 64, False, 150),
         (200, 200, 128, True, 137)]


@pytest.mark.parametrize("sq,sk,d,causal,kv_len", CASES)
def test_plain_fwd_at_the_kernel_tile_matches_jax(sq, sk, d, causal,
                                                  kv_len):
    qs, k, v = _inputs(2, sq, sk, d, torch.bfloat16, seed=sq + sk + d)
    o, lse = fa.flash_fwd_plain(qs, k, v, causal, kv_len,
                                block_k=fa.BLOCK_K)
    live = sk if kv_len is None else kv_len
    o_j, lse_j = _jax_fwd(qs, k[:, :live], v[:, :live], causal,
                          fa.BLOCK_K)
    ok, excess, fro, err = flash_close(o, o_j, BF16_REL, BF16_FROB)
    print(f"Sq={sq} Sk={sk} kv_len={live} D={d} causal={causal}: o rel "
          f"frob {fro:.3e}, worst excess {excess:.3e}")
    assert ok, (f"o: rel frob {fro:.3e} (limit {BF16_FROB:.3e}), worst "
                f"excess {excess:.3e}, max abs {err:.3e}")
    np.testing.assert_allclose(lse.numpy(), lse_j.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_forward_takes_the_kernels_64_key_walk(dtype, causal):
    """CPU tensors through flash_fwd run the plain version at the
    kernels' tile (BLOCK_K = 64 for both dtypes): the same bits as an
    explicit 64-key walk, and not those of a 128-key walk."""
    qs, k, v = _inputs(2, 300, 300, 64, dtype, seed=11)
    o, lse = fa.flash_fwd(qs, k, v, causal)
    o64, lse64 = fa.flash_fwd_plain(qs, k, v, causal, block_k=64)
    o128, _ = fa.flash_fwd_plain(qs, k, v, causal, block_k=128)
    assert fa.BLOCK_K == 64
    assert torch.equal(o, o64) and torch.equal(lse, lse64)
    assert not torch.equal(o64, o128)


def test_a_128_key_walk_leaves_the_bf16_limit():
    """At S 1024, D 64 (the generate phase's prefill width), not causal,
    P rounded against the 128-key walk's running max moves o by more than
    the card check's Frobenius limit: a kernel with 128-key softmax tiles
    could not be held to the 64-key plain version."""
    qs, k, v = _inputs(2, 1024, 1024, 64, torch.bfloat16, seed=0)
    o64, _ = fa.flash_fwd_plain(qs, k, v, False, block_k=64)
    o128, _ = fa.flash_fwd_plain(qs, k, v, False, block_k=128)
    _, excess, fro, _ = flash_close(o128, o64, BF16_REL, BF16_FROB)
    print(f"128-key against 64-key walk: rel frob {fro:.3e}")
    assert fro > BF16_FROB, f"rel frob {fro:.3e} within {BF16_FROB:.3e}"
