"""Gradients through the port's two training kernels, on the CPU, against
the JAX package's training path.

The reference trains through plain jnp (``wkv_chunked`` and
``chunked_attention`` under ``jax.grad``); the port trains through the
wkv6 and flash-attention kernels, whose backward is a kernel too
(``WKV6Function``, ``FlashAttentionFunction``).  On CPU tensors the
wrappers run their plain versions and autograd runs through them.  Here,
on the same numpy-seeded inputs:

  · autograd of ``wkv6`` and ``flash_attention`` (their plain versions on
    the CPU) against ``jax.grad`` of ``wkv_chunked`` and
    ``chunked_attention`` (KV heads repeated on the JAX side; GQA and MHA,
    causal and full), each gradient within 1e-4 of its largest magnitude;
  · ``wkv6_backward_plain`` and ``attention_backward_plain`` (the
    kernels' formulas, plain) against autograd, in f64 within 1e-10 of
    the largest magnitude, with and without a final-state adjoint;
  · the Functions' refusals: they take CUDA tensors only (``wkv6`` and
    ``flash_attention`` send CPU tensors to plain autograd), and
    ``WKV6Function`` no state that requires grad.

The kernels themselves are held against these plain backward versions on
the card by tests/test_torch_cuda.py and chip_smoke.py phase k."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.attention as JA
import repro.models.layers.rwkv6 as JR
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention.ref import (attention_backward_plain,
                                                     attention_plain)
from repro_torch.kernels.wkv6 import kernel as W
from repro_torch.kernels.wkv6.ref import wkv_ref_stepwise

TOL = 1e-4        # of each gradient's largest magnitude
F64_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def wkv_host(seed, b, s, h, hs, zero_state=True):
    """tests/test_kernels.py's wkv6 distributions, and an output cotangent."""
    rng = np.random.default_rng(seed)
    f = np.float32
    shp = (b, s, h, hs)
    host = [(0.5 * rng.standard_normal(shp)).astype(f) for _ in range(3)]
    host.append((-np.exp(rng.standard_normal(shp) - 1)).astype(f))
    host.append((0.3 * rng.standard_normal((h, hs))).astype(f))
    host.append(np.zeros((b, h, hs, hs), f) if zero_state else
                (0.5 * rng.standard_normal((b, h, hs, hs))).astype(f))
    host.append(rng.standard_normal(shp).astype(f))               # do
    host.append(rng.standard_normal((b, h, hs, hs)).astype(f))    # dstate
    return host


@pytest.mark.parametrize("shape,chunk", [((2, 64, 2, 16), 16),
                                         ((1, 32, 3, 32), 32)])
def test_wkv6_grad_matches_jax(shape, chunk):
    r, k, v, w, u, s0, do, ds = wkv_host(sum(shape), *shape)

    def jloss(*xs):
        o, st = JR.wkv_chunked(*xs, jnp.asarray(s0), chunk=chunk)
        return jnp.sum(o * do) + jnp.sum(st * ds)

    want = jax.grad(jloss, argnums=range(5))(
        *(jnp.asarray(x) for x in (r, k, v, w, u)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    o, st = W.wkv6(*ins, torch.from_numpy(s0), chunk=chunk)
    got = torch.autograd.grad((o, st), ins, (torch.from_numpy(do),
                                             torch.from_numpy(ds)))
    for g, j in zip(got, want):
        assert rel_err(g.numpy(), j) <= TOL


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("zero_state", [True, False])
def test_wkv6_backward_plain_matches_autograd(zero_state, with_dstate):
    host = wkv_host(3, 2, 24, 2, 8, zero_state)
    r, k, v, w, u, s0, do, ds = (torch.from_numpy(x).double() for x in host)
    ins = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    o, st = wkv_ref_stepwise(*ins, s0)
    outs, cots = ((o, st), (do, ds)) if with_dstate else ((o,), (do,))
    want = torch.autograd.grad(outs, ins, cots)
    got = W.wkv6_backward_plain(r, k, v, w, u, s0, do,
                                ds if with_dstate else None)
    for g, a in zip(got, want):
        assert g.dtype == torch.float64
        assert rel_err(g, a) <= F64_TOL


def test_wkv6_function_takes_cuda_tensors_only():
    """WKV6Function refuses CPU tensors (``wkv6`` never sends them there)
    and, first, a state that requires grad."""
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(x) for x in
                               wkv_host(4, 2, 32, 2, 16, False))
    ins = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        W.WKV6Function.apply(*ins, s0)
    with pytest.raises(ValueError, match="initial state"):
        W.WKV6Function.apply(*ins, s0.clone().requires_grad_())


# (B, Sq, Sk, H, KV, hd)
ATTN_SHAPES = ((2, 16, 16, 4, 2, 8), (1, 12, 12, 4, 4, 16),
               (2, 7, 20, 6, 2, 8))


def attn_host(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                          (b, sq, h, hd))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES[::2])     # GQA; Sq < Sk
def test_attention_grad_matches_jax(shape, causal):
    q, k, v, do = attn_host(sum(shape), *shape)
    g = shape[3] // shape[4]

    def jloss(q, k, v):
        o = JA.chunked_attention(q, jnp.repeat(k, g, axis=2),
                                 jnp.repeat(v, g, axis=2), causal=causal)
        return jnp.sum(o * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention(*ins, causal=causal), ins,
                              torch.from_numpy(do))
    for a, j in zip(got, want):
        assert rel_err(a.numpy(), j) <= TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_backward_plain_matches_autograd(shape, causal):
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in attn_host(sum(shape) + 1, *shape))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_plain(*ins, causal=causal), ins, do)
    got = attention_backward_plain(q, k, v, do, causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        assert rel_err(a, w) <= F64_TOL


def test_flash_function_takes_cuda_tensors_only():
    """FlashAttentionFunction refuses CPU tensors: ``flash_attention``
    never sends them there."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in attn_host(5, 2, 16, 16, 4, 1, 8))
    for causal in (True, False):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            FA.FlashAttentionFunction.apply(q, k, v, causal)


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors no kernel launches, forward or backward."""
    host = wkv_host(6, 1, 16, 2, 16)
    counts = (W.wkv6.launches, W.wkv6_bwd.launches,
              FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    ins = [torch.from_numpy(x).requires_grad_() for x in host[:5]]
    o, _ = W.wkv6(*ins, torch.from_numpy(host[5]))
    o.sum().backward()
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in attn_host(7, 1, 8, 8, 2, 2, 8))
    FA.flash_attention(q, k, v).sum().backward()
    assert counts == (W.wkv6.launches, W.wkv6_bwd.launches,
                      FA.flash_attention.launches,
                      FA.flash_attention_bwd.launches)


def test_reference_chunked_gradient_is_nan_under_strong_decay():
    """ROADMAP §3, F7: under strong decay (log decay about -20 on every
    token) ``jax.grad`` of the reference's ``wkv_chunked`` is NaN in the
    log decay's gradient: it masks exp's output, and a masked pairwise
    exponent overflows f32, so its gradient is 0 x inf.  The port's
    ``wkv6_plain`` masks the exponent instead: the same forward values (up
    to the two packages' f32 rounding) and a finite gradient.  That
    gradient of the log decay is still rounding there (the chunked form
    cancels terms far larger than it, F5); the step-by-step formulas of
    the card's backward kernel, ``wkv6_backward_plain``, in f32, are within
    1e-4 of the recurrence's gradient in f64."""
    rng = np.random.default_rng(8)
    shp = (1, 32, 1, 8)
    r, k, v = (0.5 * rng.standard_normal(shp).astype(np.float32)
               for _ in range(3))
    w = (-20 * np.exp(0.05 * rng.standard_normal(shp))).astype(np.float32)
    u = (0.3 * rng.standard_normal((1, 8))).astype(np.float32)
    s0 = np.zeros((1, 1, 8, 8), np.float32)
    jg = jax.grad(lambda *x: JR.wkv_chunked(*x, jnp.asarray(s0),
                                            chunk=16)[0].sum(),
                  argnums=range(5))(*(jnp.asarray(x) for x in (r, k, v, w,
                                                               u)))
    assert np.isnan(np.asarray(jg[3])).any()
    o_ref, _ = JR.wkv_chunked(*(jnp.asarray(x) for x in (r, k, v, w, u, s0)),
                              chunk=16)
    ins = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    o, _ = W.wkv6_plain(*ins, torch.from_numpy(s0), chunk=16)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=TOL, atol=TOL)
    for g in torch.autograd.grad(o.sum(), ins):
        assert torch.isfinite(g).all()
    got = W.wkv6_backward_plain(*(torch.from_numpy(x) for x in (r, k, v, w,
                                                                u, s0)),
                                torch.ones(shp))
    ref = [torch.from_numpy(x).double().requires_grad_()
           for x in (r, k, v, w, u)]
    o, _ = wkv_ref_stepwise(*ref, torch.from_numpy(s0).double())
    for g, t in zip(got, torch.autograd.grad(o.sum(), ref)):
        assert rel_err(g, t) <= TOL
