"""The port's Mamba sublayer (``repro_torch.models.layers.mamba``) against
the JAX package's ``models/layers/mamba.py``, on the reduced
jamba-v0.1-52b (d_model 64, d_inner 128, d_state 4, dt_rank 8, conv 4)
with the same numpy-seeded f32 weights and inputs:

  · ``init_mamba``'s leaves: names, shapes, dtypes and constants;
  · ``_conv_shift`` from a non-zero conv state: output and new state;
  · ``ssm_chunked`` at chunks 1, 8 and 64 against JAX's, and against the
    literal recurrence in f64, from a non-zero h0, within the JAX
    package's own bound for it (rtol 2e-4, atol 1e-4,
    tests/test_layers.py::test_mamba_chunked_equals_stepwise): the
    in-chunk scan composes the decays as products, in another order
    than ``lax.associative_scan``'s;
  · ``mamba_train`` and ``mamba_decode`` from a non-zero conv state and
    h0; decode steps equal to the training form;
  · gradients (weights, input, states) against ``jax.grad`` within 1e-4
    of each leaf's largest magnitude;
  · under strong decay (dt·A ~ -2,000) the outputs and gradients stay
    finite and match the recurrence in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.mamba as JM
from repro.configs import get_reduced as jget_reduced
import repro_torch.models.layers.mamba as PM
from repro_torch.configs import get_reduced

ARCH = "jamba-v0.1-52b"
SSM_TOL = dict(rtol=2e-4, atol=1e-4)      # tests/test_layers.py's
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4
B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_draw(seed):
    rng = np.random.default_rng(seed)

    def draw(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std))
    return draw


def setup(seed=0, s=S):
    """(port cfg, JAX cfg, weights with jittered constant leaves, x, conv
    state, h0), all numpy-seeded f32."""
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    p = PM.init_mamba(numpy_draw(seed), cfg)
    rng = np.random.default_rng(seed + 50)
    for name in ("conv_b", "dt_bias", "D"):
        p[name] = p[name] + torch.from_numpy(
            0.1 * rng.standard_normal(p[name].shape, dtype=np.float32))
    di = cfg.ssm.expand * cfg.d_model
    x = rng.standard_normal((B, s, cfg.d_model), dtype=np.float32)
    conv = rng.standard_normal((B, cfg.ssm.d_conv - 1, di),
                               dtype=np.float32)
    h0 = rng.standard_normal((B, di, cfg.ssm.d_state), dtype=np.float32)
    return cfg, jcfg, p, x, conv, h0


def to_jax(p):
    return {k: jnp.asarray(v.numpy()) for k, v in p.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def T(a):
    return torch.from_numpy(np.asarray(a).copy())


def ssm_inputs(seed, s, strong=False):
    """dt, a, bmat, cmat, u, h0 as the JAX test draws them (numpy here);
    strong: decays exp(dt a) down to exp(-2,000)."""
    rng = np.random.default_rng(seed)
    di, ds = 8, 4
    dt = np.log1p(np.exp(rng.standard_normal((B, s, di)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, ds))).astype(np.float32)
    if strong:
        dt = (dt * 200).astype(np.float32)
        a = (a * 10).astype(np.float32)
    bmat, cmat = (rng.standard_normal((B, s, ds)).astype(np.float32)
                  for _ in range(2))
    u = rng.standard_normal((B, s, di)).astype(np.float32)
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    return dt, a, bmat, cmat, u, h0


def recurrence(dt, a, bmat, cmat, u, h0):
    """The literal step-by-step recurrence, in the inputs' dtype."""
    h, ys = h0, []
    for i in range(dt.shape[1]):
        da = torch.exp(dt[:, i, :, None] * a)
        h = da * h + (dt[:, i] * u[:, i])[..., None] * bmat[:, i, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, i]))
    return torch.stack(ys, 1), h


def test_init_layout_matches_jax():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda k: JM.init_mamba(k, jcfg, jnp.float32),
                          jax.random.PRNGKey(0))
    got = PM.init_mamba(numpy_draw(0), cfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
        assert got[k].dtype == torch.float32
    ref = JM.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    for k in ("conv_b", "dt_bias", "A_log", "D"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


def test_conv_shift_from_a_state():
    cfg, _, p, x, conv, _ = setup(1)
    di = cfg.ssm.expand * cfg.d_model
    u = np.random.default_rng(3).standard_normal((B, 9, di),
                                                 dtype=np.float32)
    got, state = PM._conv_shift(T(u), p["conv_w"], p["conv_b"], T(conv))
    want, wstate = JM._conv_shift(jnp.asarray(u), jnp.asarray(
        p["conv_w"].numpy()), jnp.asarray(p["conv_b"].numpy()),
        jnp.asarray(conv))
    close(got, want, dict(rtol=1e-6, atol=1e-6))
    assert np.array_equal(state.numpy(), np.asarray(wstate))
    assert np.array_equal(state.numpy(), u[:, -3:])


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_ssm_chunked_matches_jax(chunk):
    args = ssm_inputs(chunk, S)
    y, h = PM.ssm_chunked(*map(T, args), chunk=chunk)
    jy, jh = JM.ssm_chunked(*map(jnp.asarray, args), chunk=chunk)
    close(y, jy, SSM_TOL)
    close(h, jh, SSM_TOL)
    wy, wh = recurrence(*(T(a).double() for a in args))
    close(y, wy.float(), SSM_TOL)
    close(h, wh.float(), SSM_TOL)


def test_ssm_chunks_agree_with_each_other():
    """A ragged number of chunks is refused, as in the reference; chunks
    of 16 and of 64 give the same sequence to rounding."""
    args = tuple(map(T, ssm_inputs(7, S)))
    y16, h16 = PM.ssm_chunked(*args, chunk=16)
    y64, h64 = PM.ssm_chunked(*args, chunk=64)
    close(y16, y64, SSM_TOL)
    close(h16, h64, SSM_TOL)
    with pytest.raises(ValueError, match="40 steps"):
        PM.ssm_chunked(*(a[:, :40] if a.dim() == 3 else a for a in args),
                       chunk=16)


def test_mamba_train_matches_jax():
    cfg, jcfg, p, x, conv, h0 = setup(2)
    out, new_conv, h_end = PM.mamba_train(p, T(x), T(conv), T(h0), cfg=cfg)
    jout, jconv, jh = JM.mamba_train(to_jax(p), jnp.asarray(x),
                                     jnp.asarray(conv), jnp.asarray(h0),
                                     cfg=jcfg)
    close(out, jout)
    assert np.array_equal(new_conv.numpy(), np.asarray(jconv))
    close(h_end, jh, SSM_TOL)


def test_mamba_decode_matches_jax():
    cfg, jcfg, p, x, conv, h0 = setup(3, s=1)
    out, new_conv, h = PM.mamba_decode(p, T(x), T(conv), T(h0), cfg=cfg)
    jout, jconv, jh = JM.mamba_decode(to_jax(p), jnp.asarray(x),
                                      jnp.asarray(conv), jnp.asarray(h0),
                                      cfg=jcfg)
    close(out, jout)
    assert np.array_equal(new_conv.numpy(), np.asarray(jconv))
    close(h, jh, SSM_TOL)


def test_decode_steps_equal_train():
    cfg, _, p, x, conv, h0 = setup(4, s=16)
    out, conv_end, h_end = PM.mamba_train(p, T(x), T(conv), T(h0), cfg=cfg)
    module = PM.Mamba(cfg, p)
    c, h, steps = T(conv), T(h0), []
    for i in range(16):
        y, c, h = module.decode(T(x[:, i:i + 1]), c, h)
        steps.append(y)
    close(torch.cat(steps, 1), out.detach())
    assert torch.equal(c, conv_end)
    close(h, h_end.detach(), SSM_TOL)
    assert sorted(n for n, _ in module.named_parameters()) == sorted(p)


def _grad_err(got, want):
    w = np.asarray(want)
    return np.abs(got.numpy() - w).max() / max(np.abs(w).max(), 1e-30)


def test_grads_match_jax():
    cfg, jcfg, p, x, conv, h0 = setup(5)
    g_out = np.random.default_rng(9).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)
    g_h = np.random.default_rng(10).standard_normal(h0.shape,
                                                    dtype=np.float32)

    def jloss(params, x, conv, h0):
        out, _, h = JM.mamba_train(params, x, conv, h0, cfg=jcfg)
        return jnp.sum(out * g_out) + jnp.sum(h * g_h)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        to_jax(p), jnp.asarray(x), jnp.asarray(conv), jnp.asarray(h0))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    ins = [T(a).requires_grad_() for a in (x, conv, h0)]
    out, _, h = PM.mamba_train(leaves, *ins, cfg=cfg)
    loss = (out * T(g_out)).sum() + (h * T(g_h)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()) + ins)
    for (name, _), g in zip(leaves.items(), grads):
        assert _grad_err(g, jg[0][name]) <= GRAD_TOL, name
    for name, g, w in zip(("x", "conv", "h0"), grads[len(leaves):], jg[1:]):
        assert _grad_err(g, w) <= GRAD_TOL, name


def test_strong_decay_stays_finite():
    """dt·A down to ~-2,000: the decays underflow to 0 and the state
    forgets, which the product form takes as it comes; the outputs and
    the gradients of every input are finite and match the recurrence
    (both in f64 as the truth, and the f32 scan within the bound)."""
    args = ssm_inputs(11, S, strong=True)
    assert float(np.min(args[0][..., None] * args[1])) < -1000
    ins = [T(a).requires_grad_() for a in args]
    y, h = PM.ssm_chunked(*ins, chunk=64)
    gy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        y.shape).astype(np.float32))
    grads = torch.autograd.grad((y * gy).sum() + h.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    truth = [T(a).double().requires_grad_() for a in args]
    wy, wh = recurrence(*truth)
    wgrads = torch.autograd.grad((wy * gy.double()).sum() + wh.sum(), truth)
    close(y, wy.detach().float(), SSM_TOL)
    for g, w in zip(grads, wgrads):
        assert _grad_err(g, w.float()) <= GRAD_TOL
