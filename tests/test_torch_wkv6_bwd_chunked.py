"""The wkv backward kernel's chunked algebra, on the CPU.

``csrc/wkv6_bwd.cu`` computes the gradient of the wkv recurrence in
chunks of 32 tokens (two sub-chunks of 16 around the reference point
L_15, decays as products of exp(w), dw expanded into terms that do not
cancel).  No card runs here, so ``wkv6_backward_chunked_plain`` repeats
those formulas in torch, and these tests hold it, on numpy-seeded inputs
with random, strong (log decay ~ -20) and weak (~ -1e-6) decay, ragged
lengths, a zero or seeded initial state, with and without a final-state
adjoint:

  · in f64 against ``wkv6_backward_plain`` (the stepwise recurrence) in
    f64, within 1e-10 of each gradient's largest magnitude: the algebra;
  · in f32 against the same f64 truth, within 1e-5: its rounding, dw
    under strong decay included (a cumulative-sum dw misses by ~1 there);
  · in f32 against ``jax.grad`` of the JAX package's ``wkv_chunked``,
    within 1e-4 (random decay: the reference's own gradient is NaN under
    strong decay, ROADMAP §3 F7);
  · its decay products against exp of the cumulative log decays in f64.

The kernel itself is held against ``wkv6_backward_plain`` on the card by
tests/test_torch_cuda.py and chip_smoke.py phase k."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.rwkv6 as JR
from repro_torch.kernels.wkv6 import kernel as W

F64_TOL = 1e-10
F32_TOL = 1e-5      # f32 rounding, of each gradient's largest magnitude
JAX_TOL = 1e-4      # tests/test_torch_train_kernels.py's


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def host(seed, b, s, h, hs, decay="random", zero_state=False):
    """r, k, v (0.5 N), log decay, u (0.3 N), initial state, do, dstate,
    f64 numpy."""
    rng = np.random.default_rng(seed)
    shp = (b, s, h, hs)
    r, k, v = (0.5 * rng.standard_normal(shp) for _ in range(3))
    z = rng.standard_normal(shp)
    w = {"random": -np.exp(z - 1), "strong": -20 * np.exp(0.05 * z),
         "weak": -1e-6 * np.exp(0.3 * z)}[decay]
    u = 0.3 * rng.standard_normal((h, hs))
    s0 = (np.zeros((b, h, hs, hs)) if zero_state
          else 0.5 * rng.standard_normal((b, h, hs, hs)))
    return (r, k, v, w, u, s0, rng.standard_normal(shp),
            rng.standard_normal((b, h, hs, hs)))


# (B, S, H, hs): one chunk, ragged tails of one and of 31 tokens, one token
SHAPES = ((2, 32, 2, 16), (1, 65, 2, 32), (2, 37, 1, 16), (1, 1, 2, 16))


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("decay", ["random", "strong", "weak"])
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_backward_equals_stepwise_in_f64(shape, decay, with_dstate):
    *xs, do, ds = (torch.from_numpy(x) for x in host(sum(shape), *shape,
                                                      decay))
    ds = ds if with_dstate else None
    got = W.wkv6_backward_chunked_plain(*xs, do, ds)
    want = W.wkv6_backward_plain(*xs, do, ds)
    for g, a in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == a.shape
        assert rel_err(g, a) <= F64_TOL


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("decay", ["random", "strong", "weak"])
def test_chunked_backward_in_f32_holds_to_f64(decay, zero_state):
    shape = (2, 70, 2, 32)
    *xs, do, ds = host(7, *shape, decay, zero_state)
    f32 = [torch.from_numpy(x).float() for x in (*xs, do, ds)]
    got = W.wkv6_backward_chunked_plain(*f32)
    want = W.wkv6_backward_plain(*(torch.from_numpy(x) for x in (*xs, do,
                                                                  ds)))
    for g, a in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.isfinite(g).all()
        assert rel_err(g, a) <= F32_TOL


@pytest.mark.parametrize("shape,chunk", [((2, 64, 2, 16), 16),
                                         ((1, 96, 3, 32), 32)])
def test_chunked_backward_matches_jax_grad(shape, chunk):
    r, k, v, w, u, s0, do, ds = (x.astype(np.float32) for x in
                                 host(sum(shape) + 1, *shape))

    def jloss(*xs):
        o, st = JR.wkv_chunked(*xs, jnp.asarray(s0), chunk=chunk)
        return jnp.sum(o * do) + jnp.sum(st * ds)

    want = jax.grad(jloss, argnums=range(5))(
        *(jnp.asarray(x) for x in (r, k, v, w, u)))
    got = W.wkv6_backward_chunked_plain(
        *(torch.from_numpy(x) for x in (r, k, v, w, u, s0, do, ds)))
    for g, j in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(j)) <= JAX_TOL


@pytest.mark.parametrize("decay", ["random", "strong"])
def test_decay_products_are_the_cumulative_decays(decay):
    """cf = exp(Lp_t), cb = exp(L_end - L_t), cend = exp(L_end), and rf =
    exp(L_15 - L_s) on the first sub-chunk, exp(Lp_t - L_15) on the
    second, from exp(w) of one chunk (B, H, 32, hs)."""
    w = torch.from_numpy(host(3, 2, 32, 3, 8, decay)[3]).permute(0, 2, 1, 3)
    cf, cb, rf, cend = W._decays(torch.exp(w))
    L = torch.cumsum(w, 2)
    Lp = L - w
    ref = L[:, :, 15:16]
    want_rf = torch.cat([torch.exp(ref - L[:, :, :16]),
                         torch.exp(Lp[:, :, 16:] - ref)], 2)
    for got, want in ((cf, torch.exp(Lp)), (cb, torch.exp(L[:, :, -1:] - L)),
                      (rf, want_rf), (cend, torch.exp(L[:, :, -1]))):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
