"""Port parity: the grouped matmul of paddle_tpu_torch against paddle_tpu's,
on the CPU.

The JAX ``grouped_matmul`` (Pallas in interpret mode, row tile 8) and the
port's (its plain PyTorch versions, since the tensors lie on the CPU) get
the same f32 inputs on the five group layouts of
``tests/test_grouped_matmul.py``: forward, dX and dW agree to 1e-5
(relative and absolute; f32 sums of up to 16 products in another
order). Dead-tail rows and the dW of empty experts must be exactly zero,
and the schedule bitwise equal. The JAX side is not held bitwise to a
dense einsum here: that reference test fails on this tree.

The card kernels take 128-row tiles and run bf16 on the tensor cores, so
the same chain is closed at their tile and dtype too: bf16 at
``tile_rows`` = 128, (K, N) = (256, 192) (a 64-wide last block of N) and
(128, 256), on an empty expert and on counts off the tile, under
chip_smoke's bf16 rule (``flash_close`` with ``GMM_TOL``: both sides sum
in f32 and round once, so an element may land one bf16 step apart).
There the card check holds each kernel to the same plain version.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import GMM_TOL, flash_close
from paddle_tpu.ops import _common
from paddle_tpu.ops import grouped_matmul as jg

from paddle_tpu_torch.ops import grouped_matmul as tg

TM = 8
LAYOUTS = [
    ("empty_experts", [0, 3, 0, 5]),
    ("all_one_expert", [20, 0, 0, 0]),
    ("non_tile_multiple", [5, 11, 7, 13]),
    ("tile_aligned", [8, 16, 8, 8]),
    ("eight_experts", [0, 9, 1, 0, 24, 3, 0, 8]),
]
TOL = dict(rtol=1e-5, atol=1e-5)
# one compile per layout instead of one per primitive and shape
_jax_schedule = jax.jit(jg.tile_schedule, static_argnums=(1, 2))


@pytest.fixture(autouse=True)
def _interpret():
    with _common.interpret_mode(True):
        yield


@functools.lru_cache(maxsize=None)
def _layout(counts):
    """Counts as a tuple -> (counts, M, live rows, JAX schedule, port
    schedule), with two dead tail tiles past the last group."""
    counts = np.asarray(counts, np.int32)
    aligned = -(-counts // TM) * TM
    live_rows = int(aligned.sum())
    m = live_rows + 2 * TM
    sched_j = _jax_schedule(jnp.asarray(counts), m // TM, TM)
    sched_t = tg.tile_schedule(torch.from_numpy(counts), m // TM, TM)
    return counts, m, live_rows, sched_j, sched_t


@pytest.mark.parametrize("name,counts", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_tile_schedule_bitwise(name, counts):
    """Two dead tail tiles: their expert clamps to E-1 and live is 0."""
    _, _, _, sched_j, sched_t = _layout(tuple(counts))
    for a, b in zip(sched_j, sched_t):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name,counts", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_gmm_forward_and_grads_match_jax(name, counts):
    rng = np.random.RandomState(0)
    counts, m, live_rows, sched_j, sched_t = _layout(tuple(counts))
    E, K, N = len(counts), 16, 8
    lhs = rng.randn(m, K).astype(np.float32)
    rhs = rng.randn(E, K, N).astype(np.float32)
    cot = rng.randn(m, N).astype(np.float32)

    @jax.jit
    def value_and_pull(a, w, c):
        out, pull = jax.vjp(
            lambda a, w: jg.grouped_matmul(a, w, sched_j[:4], TM), a, w)
        return (out,) + pull(c)

    out_j, dx_j, dw_j = value_and_pull(jnp.asarray(lhs), jnp.asarray(rhs),
                                       jnp.asarray(cot))

    lt = torch.from_numpy(lhs).requires_grad_()
    rt = torch.from_numpy(rhs).requires_grad_()
    before = (tg.gmm_fwd.launches, tg.gmm_dx.launches, tg.gmm_dw.launches)
    out = tg.grouped_matmul(lt, rt, sched_t[:2], TM)
    out.backward(torch.from_numpy(cot))
    # CPU tensors run the plain versions: no kernel is launched
    assert (tg.gmm_fwd.launches, tg.gmm_dx.launches,
            tg.gmm_dw.launches) == before

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(dw_j), **TOL)
    # dead-tail rows are exactly zero in the output and in dX
    assert (out.detach().numpy()[live_rows:] == 0).all()
    assert (lt.grad.numpy()[live_rows:] == 0).all()
    for e in range(E):
        if counts[e] == 0:
            assert (rt.grad.numpy()[e] == 0).all(), f"expert {e} dW"


CARD_TM = 128
CARD_LAYOUTS = [("empty_expert", [0, 300, 77, 0]),
                ("off_the_tile", [1, 127, 129, 0])]
CARD_SHAPES = [(256, 192), (128, 256)]


@pytest.mark.parametrize("kn", CARD_SHAPES,
                         ids=[f"K{k}_N{n}" for k, n in CARD_SHAPES])
@pytest.mark.parametrize("name,counts", CARD_LAYOUTS,
                         ids=[n for n, _ in CARD_LAYOUTS])
def test_gmm_bf16_at_the_card_tile_matches_jax(name, counts, kn):
    """bf16 forward, dX and dW at 128-row tiles, one dead tail tile past
    the groups: the port's plain versions (CPU tensors) against JAX's
    vjp (interpret mode); dead rows and empty experts exactly zero."""
    k, n = kn
    rng = np.random.RandomState(k + n)
    counts = np.asarray(counts, np.int32)
    live_rows = int((-(-counts // CARD_TM) * CARD_TM).sum())
    m = live_rows + CARD_TM
    e = len(counts)
    lhs = rng.randn(m, k).astype(np.float32)
    rhs = (rng.randn(e, k, n) / np.sqrt(k)).astype(np.float32)
    cot = rng.randn(m, n).astype(np.float32)
    sched_j = _jax_schedule(jnp.asarray(counts), m // CARD_TM, CARD_TM)
    bf = jnp.bfloat16

    @jax.jit
    def value_and_pull(a, w, c):
        out, pull = jax.vjp(
            lambda a, w: jg.grouped_matmul(a, w, sched_j[:4], CARD_TM), a, w)
        return (out,) + pull(c)

    want = [torch.tensor(np.asarray(x.astype(jnp.float32)))
            for x in value_and_pull(jnp.asarray(lhs).astype(bf),
                                    jnp.asarray(rhs).astype(bf),
                                    jnp.asarray(cot).astype(bf))]

    sched_t = tg.tile_schedule(torch.from_numpy(counts), m // CARD_TM,
                               CARD_TM)
    lt = torch.from_numpy(lhs).to(torch.bfloat16).requires_grad_()
    rt = torch.from_numpy(rhs).to(torch.bfloat16).requires_grad_()
    out = tg.grouped_matmul(lt, rt, sched_t[:2], CARD_TM)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    got = [out.detach(), lt.grad, rt.grad]

    rel, frob = GMM_TOL[torch.bfloat16]
    for what, a, b in zip(("forward", "dX", "dW"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, what
        ok, excess, fro, err = flash_close(a, b, rel, frob)
        assert ok, (f"{what}: worst excess over the limit {excess:.3e}, "
                    f"rel frob {fro:.3e}, max abs err {err:.3e}")
    assert (got[0][live_rows:] == 0).all() and (got[1][live_rows:] == 0).all()
    assert (want[0][live_rows:] == 0).all() and (want[1][live_rows:] == 0).all()
    for x in np.flatnonzero(counts == 0):
        assert (got[2][x] == 0).all() and (want[2][x] == 0).all(), x


def test_gmm_plain_pieces_and_dtypes():
    """The three plain functions directly, in bf16: outputs in the
    documented dtypes, rounded once from an f32 sum."""
    rng = np.random.RandomState(3)
    counts, m, live_rows, _, sched = _layout((3, 0, 9))
    bf = torch.bfloat16
    lhs = torch.from_numpy(rng.randn(m, 16).astype(np.float32)).to(bf)
    rhs = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32)).to(bf)
    dout = torch.from_numpy(rng.randn(m, 8).astype(np.float32)).to(bf)
    out = tg.gmm_fwd(lhs, rhs, sched[:2], TM)
    dx = tg.gmm_dx(dout, rhs, sched[:2], TM)
    dw = tg.gmm_dw(lhs, dout, sched[:2], TM, num_experts=3)
    assert out.dtype == dx.dtype == dw.dtype == bf
    assert dw.shape == (3, 16, 8) and (dw[1] == 0).all()
    rows = slice(0, 8)     # tile 0 is expert 0's
    want = (lhs[rows].float() @ rhs[0].float()).to(bf)
    assert torch.equal(out[rows], want)
    want = (lhs[0:8].float().T @ dout[0:8].float()).to(bf)
    assert torch.equal(dw[0], want)
    assert (out[live_rows:] == 0).all() and (dx[live_rows:] == 0).all()


def test_gmm_refuses_bad_shapes():
    _, m, _, _, sched = _layout((5, 3))
    lhs, rhs = torch.zeros((m, 16)), torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="multiple of tile_rows"):
        tg.grouped_matmul(torch.zeros((m + 1, 16)), rhs, sched[:2], TM)
    with pytest.raises(ValueError, match="schedule"):
        tg.gmm_fwd(lhs, rhs, tuple(s[:-1] for s in sched[:2]), TM)
    with pytest.raises(ValueError, match="contraction"):
        tg.gmm_fwd(lhs, torch.zeros((2, 8, 8)), sched[:2], TM)
    with pytest.raises(ValueError, match="num_experts"):
        tg.gmm_dw(lhs, torch.zeros((m, 8)), sched[:2], TM)


def test_gmm_default_tile_matches_jax():
    assert tg.TILE_ROWS == jg.TILE_ROWS == 128
