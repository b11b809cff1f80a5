"""The wkv6 CUDA kernel's arithmetic, mirrored in plain PyTorch on the CPU,
against the recurrence in f64 and the JAX package's Pallas kernel.

``wkv6_mirror`` does what ``src/repro_torch/kernels/wkv6/csrc/wkv6.cu``
does: chunks of 32 tokens, zero-padded past S; the exclusive and inclusive
sums of the log decay; two sub-chunks of 16, the off-diagonal block of the
scores through factors around the reference point L_15, the diagonal
blocks token by token (k_s scaled by one exp(w) a step, the exact
pairwise decays without an exponent above 0) with the u bonus on the
diagonal; the
four products (inter-chunk, off-diagonal scores, scores times v, state
update) on emulated TF32 tensor cores, three passes of a big/small split
(``tests/_tf32.py``, sums in f64).  It is
held within rtol = atol = 1e-4 (tests/test_kernels.py's wkv6 tolerance) of

  · the port's ``wkv_ref_stepwise`` in f64 (the card's truth), and
  · the JAX ``wkv6_pallas`` in interpret mode (zero initial state, its
    contract) or the JAX ``wkv_chunked`` oracle (any initial state),

on hs 16/32/64 x S 1/16/37/64/128 x zero and random initial states, and
under strong decay (log decay about -20 on every token: the naive
factorisation exp(Lp_t) exp(-L_s) overflows f32 there, the mirror stays
finite) and weak decay (about -1e-6).  Under strong decay the JAX forms
run at chunk 1: at their default chunk of 64 they, and the port's
wkv6_plain, are themselves above the tolerance from f64 (ROADMAP §3, F5,
reproduced here), since
they form Lprev = L - w in f32 where |L| reaches hundreds; the kernel
takes the exclusive sum instead.  One TF32 pass misses the tolerance.
The kernel itself is held against ``wkv6_plain`` on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.layers.rwkv6 as JR
from _tf32 import tf32_mm
from repro.kernels.wkv6.kernel import wkv6_pallas
from repro_torch.kernels.wkv6.kernel import wkv6_plain
from repro_torch.kernels.wkv6.ref import wkv_ref_stepwise

TOL = dict(rtol=1e-4, atol=1e-4)
C, SUB = 32, 16                 # the kernel's chunk and sub-chunk


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wkv6_mirror(r, k, v, w, u, state, passes=3):
    """The kernel's arithmetic on (B, S, H, hs) f32 inputs, u (H, hs) and
    state (B, H, hs, hs); returns (o (B, S, H, hs), final state)."""
    b, s, h, hs = r.shape
    n = -(-s // C)
    pad = n * C - s
    rr, kk, vv, ww = (F.pad(x.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
                      for x in (r, k, v, w))          # (B, H, n C, hs)
    S = state.float()
    outs = []
    for c in range(n):
        ch = slice(c * C, (c + 1) * C)
        rc, kc, vc = rr[:, :, ch], kk[:, :, ch], vv[:, :, ch]
        L = torch.cumsum(ww[:, :, ch], dim=2)
        Lp = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
        # the off-diagonal block: both factors around L_ref = L_15 are <= 1
        lref = L[:, :, SUB - 1:SUB]
        qt = rc[:, :, SUB:] * torch.exp(Lp[:, :, SUB:] - lref)
        kt = kc[:, :, :SUB] * torch.exp(lref - L[:, :, :SUB])
        A = torch.zeros(b, h, C, C)
        A[:, :, SUB:, :SUB] = tf32_mm(qt, kt.transpose(-1, -2), passes)
        # the diagonal blocks, in f32: for t > s, k_s times exp(w_m) for
        # s < m < t, one factor a step; the u bonus at t = s
        e = torch.exp(ww[:, :, ch])
        for a in range(C // SUB):
            sl = slice(a * SUB, (a + 1) * SUB)
            ra, ka, ea = rc[:, :, sl], kc[:, :, sl], e[:, :, sl]
            blk = torch.diag_embed((ra * u.float()[None, :, None] * ka)
                                   .sum(-1))
            kd = ka.clone()
            for t in range(1, SUB):
                blk[:, :, t, :t] = (ra[:, :, t, None] * kd[:, :, :t]).sum(-1)
                kd[:, :, :t] = kd[:, :, :t] * ea[:, :, t, None]
            A[:, :, sl, sl] = blk
        rdec = rc * torch.exp(Lp)
        kdec = kc * torch.exp(L[:, :, -1:] - L)
        outs.append(tf32_mm(rdec, S, passes) + tf32_mm(A, vc, passes))
        S = torch.exp(L[:, :, -1])[..., None] * S + tf32_mm(
            kdec.transpose(-1, -2), vc, passes)
    return torch.cat(outs, 2)[:, :, :s].transpose(1, 2), S


def inputs(seed, b, s, h, hs, zero_state, decay="random"):
    """tests/test_kernels.py's distributions (r, k, v ~ 0.5 N, u ~ 0.3 N,
    log decay -exp(N - 1)), or a log decay about -20 ("strong") or about
    -1e-6 ("weak") on every token; the state ~ 0.5 N or zero."""
    rng = np.random.default_rng(seed)
    f = np.float32
    shp = (b, s, h, hs)
    r, k, v = ((0.5 * rng.standard_normal(shp)).astype(f) for _ in range(3))
    z = rng.standard_normal(shp)
    w = {"random": -np.exp(z - 1), "strong": -20 * np.exp(0.05 * z),
         "weak": -1e-6 * np.exp(0.3 * z)}[decay].astype(f)
    u = (0.3 * rng.standard_normal((h, hs))).astype(f)
    st = (np.zeros((b, h, hs, hs), f) if zero_state
          else (0.5 * rng.standard_normal((b, h, hs, hs))).astype(f))
    return [torch.from_numpy(x) for x in (r, k, v, w, u, st)]


def jax_reference(args, zero_state, chunk=64):
    """The Pallas kernel in interpret mode from the zero state, its
    chunked oracle from any other."""
    ja = [jnp.asarray(a.numpy()) for a in args]
    if zero_state:
        return wkv6_pallas(*ja[:5], chunk=chunk)
    return JR.wkv_chunked(*ja, chunk=chunk)


def err_over_tol(got, want):
    """allclose's measure, max |got - want| / (atol + rtol |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


def check(args, zero_state, passes=3, jax_chunk=64):
    got = wkv6_mirror(*args, passes=passes)
    truth = wkv_ref_stepwise(*(a.double() for a in args))
    for g, t, j in zip(got, truth,
                       jax_reference(args, zero_state, jax_chunk)):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        np.testing.assert_allclose(g.double().numpy(), t.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    return got


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("s", [1, 16, 37, 64, 128])
@pytest.mark.parametrize("hs", [16, 32, 64])
def test_mirror_matches_f64_and_jax(hs, s, zero_state):
    o, st = check(inputs(hs * 1000 + s, 1, s, 2, hs, zero_state), zero_state)
    assert o.shape == (1, s, 2, hs) and st.shape == (1, 2, hs, hs)


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("hs", [16, 32, 64])
def test_mirror_under_strong_decay(hs, zero_state):
    """Log decay about -20 on every token: |L| reaches ~640 within a chunk,
    where exp(-L) alone overflows f32; the sub-chunk factors keep every
    exponent <= 0 and every output finite."""
    args = inputs(hs + 1, 2, 37, 2, hs, zero_state, "strong")
    L = torch.cumsum(args[3][:, :C], dim=1)
    assert torch.isinf(torch.exp(-L)).any()   # the naive factor's trap
    check(args, zero_state, jax_chunk=1)


def test_reference_chunked_form_drifts_under_strong_decay():
    """ROADMAP §3, F5: under strong decay the Pallas kernel and the port's
    wkv6_plain at their chunk of 64 are more than the tolerance from the
    recurrence in f64 (Lprev = L - w loses the low bits of w where |L|
    passes 1,000); at chunk 1 both, and the mirror, are well within it.
    At (2, 64, 4, 64) err/tol is 2.47 for the Pallas kernel and 3.10 for
    wkv6_plain at chunk 64, and below 0.01 at chunk 1 and for the
    mirror."""
    args = inputs(65, 2, 64, 4, 64, True, "strong")
    truth = wkv_ref_stepwise(*(a.double() for a in args))[0].numpy()
    err = {(name, chunk): err_over_tol(fn(chunk), truth)
           for chunk in (64, 1) for name, fn in (
               ("pallas", lambda c: jax_reference(args, True, c)[0]),
               ("plain", lambda c: wkv6_plain(*args, chunk=c)[0]))}
    err["mirror"] = err_over_tol(wkv6_mirror(*args)[0], truth)
    assert min(err["pallas", 64], err["plain", 64]) > 1.5, err
    assert max(err["pallas", 1], err["plain", 1], err["mirror"]) < 0.01, err


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("hs", [16, 32, 64])
def test_mirror_under_weak_decay(hs, zero_state):
    """Log decay about -1e-6: the state carries over the whole sequence."""
    check(inputs(hs + 2, 2, 128, 2, hs, zero_state, "weak"), zero_state)


def test_one_tf32_pass_misses_the_tolerance():
    """Three passes hold 1e-4 against f64; one pass (operands rounded to
    TF32, ~3 decimal digits) does not."""
    args = inputs(3, 1, 128, 2, 64, False)
    truth = wkv_ref_stepwise(*(a.double() for a in args))
    check(args, False, passes=3)
    one = wkv6_mirror(*args, passes=1)
    assert not all(np.allclose(g.double().numpy(), t.numpy(), **TOL)
                   for g, t in zip(one, truth))
