"""The port's RWKV-6 layer and the wkv6 kernel's plain versions against the
JAX package, on the same numpy-seeded f32 inputs.

  · ``_ddlerp``, ``_decay_log``, ``wkv_chunked``, ``wkv_step``,
    ``time_mix_train``, ``time_mix_decode``, ``channel_mix`` and the norms
    against the JAX functions, rtol/atol 1e-5: the same f32 arithmetic,
    summed in a different order.
  · ``wkv6_plain`` (the wrapper on CPU tensors) and the port's
    ``wkv_ref_stepwise`` against JAX's ``wkv6_pallas`` in interpret mode
    and its ``wkv_ref_stepwise``, at tests/test_kernels.py's shapes,
    rtol/atol 1e-4 (that file's tolerance).

The CUDA kernel itself is held against ``wkv6_plain`` on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.common as JCOM
import repro.models.layers.rwkv6 as JR
from repro.configs import get_reduced as jget_reduced
from repro.kernels.wkv6.kernel import wkv6_pallas
from repro.kernels.wkv6.ref import wkv_ref_stepwise as jwkv_stepwise
import repro_torch.models.layers.common as PCOM
import repro_torch.models.layers.rwkv6 as PR
from repro_torch.configs import get_reduced
from repro_torch.convert import seeded_lm_params
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6.ref import wkv_ref_stepwise

ARCH = "rwkv6-1.6b"
TOL = dict(rtol=1e-5, atol=1e-5)
KTOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want), **tol)


def wkv_inputs(seed, b, s, h, hs, state=True):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.5 N, log decay
    -exp(N - 1), u ~ 0.3 N; the state ~ 0.5 N or zero."""
    rng = np.random.default_rng(seed)
    shp = (b, s, h, hs)
    f = np.float32
    r, k, v = ((0.5 * rng.standard_normal(shp)).astype(f) for _ in range(3))
    w = (-np.exp(rng.standard_normal(shp) - 1)).astype(f)
    u = (0.3 * rng.standard_normal((h, hs))).astype(f)
    st = ((0.5 * rng.standard_normal((b, h, hs, hs))).astype(f) if state
          else np.zeros((b, h, hs, hs), f))
    return r, k, v, w, u, st


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def layer_params(seed):
    """Layer 0 of the seeded reduced model, with the constant leaves
    (mixes, group-norm scale and bias) drawn too."""
    cfg = get_reduced(ARCH)
    tree = seeded_lm_params(cfg, seed)["groups"][0]
    rng = np.random.default_rng(seed + 1)
    tm = {k: np.array(v[0]) for k, v in tree["tm"].items()}
    cm = {k: np.array(v[0]) for k, v in tree["cm"].items()}
    for p, names in ((tm, ("mu_x", "mu")), (cm, ("mu_k", "mu_r"))):
        for n in names:
            p[n] = rng.random(p[n].shape).astype(np.float32)
    tm["gn_scale"] = (1 + 0.2 * rng.standard_normal(tm["gn_scale"].shape)
                      ).astype(np.float32)
    tm["gn_bias"] = (0.2 * rng.standard_normal(tm["gn_bias"].shape)
                     ).astype(np.float32)
    return cfg, tm, cm


def jt(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def pt(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def activations(seed, b, s, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    shift = rng.standard_normal((b, d)).astype(np.float32)
    return x, shift


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    assert set(PCOM.init_norm(kind, 64)) == set(JCOM.init_norm(
        kind, 64, jnp.float32))
    close(PCOM.apply_norm(pt(p), torch.from_numpy(x), kind=kind, eps=1e-5),
          JCOM.apply_norm(jt(p), jnp.asarray(x), kind=kind, eps=1e-5), TOL)


def test_group_norm_heads():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    sc, bi = (rng.standard_normal((4, 16)).astype(np.float32)
              for _ in range(2))
    close(PCOM.group_norm_heads(*(torch.from_numpy(a) for a in (x, sc, bi))),
          JCOM.group_norm_heads(*(jnp.asarray(a) for a in (x, sc, bi))), TOL)


# ---------------------------------------------------------------------------
# the layer's pieces
# ---------------------------------------------------------------------------

def test_ddlerp_and_decay_log():
    cfg, tm, _ = layer_params(0)
    x, shift = activations(1, 2, 8, cfg.d_model)
    x_prev = np.concatenate([shift[:, None], x[:, :-1]], 1)
    got = PR._ddlerp(pt(tm), torch.from_numpy(x), torch.from_numpy(x_prev))
    want = JR._ddlerp(jt(tm), jnp.asarray(x), jnp.asarray(x_prev))
    assert len(got) == len(want) == PR.N_MIX
    for g, w in zip(got, want):
        close(g, w, TOL)
    close(PR._decay_log(pt(tm), got[0]),
          JR._decay_log(jt(tm), want[0]), TOL)


@pytest.mark.parametrize("s,chunk", [(16, 64), (32, 8), (24, 8), (1, 1)])
def test_wkv_chunked(s, chunk):
    arrays = wkv_inputs(s + chunk, 2, s, 3, 16)
    ja, pa = both(arrays)
    go, gs = PR.wkv_chunked(*pa, chunk=chunk)
    wo, ws = JR.wkv_chunked(*ja, chunk=chunk)
    close(go, wo, TOL)
    close(gs, ws, TOL)


def test_wkv_step():
    r, k, v, w, u, st = wkv_inputs(7, 2, 1, 3, 16)
    step = [a[:, 0] for a in (r, k, v, w)] + [u, st]
    ja, pa = both(step)
    go, gs = PR.wkv_step(*pa)
    wo, ws = JR.wkv_step(*ja)
    close(go, wo, TOL)
    close(gs, ws, TOL)


@pytest.mark.parametrize("s,chunk", [(16, 64), (32, 8)])
def test_time_mix_train(s, chunk):
    cfg, tm, _ = layer_params(2)
    jcfg = jget_reduced(ARCH)
    x, shift = activations(s, 2, s, cfg.d_model)
    h, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    st = np.random.default_rng(5).standard_normal(
        (2, h, hs, hs)).astype(np.float32)
    got = PR.time_mix_train(pt(tm), *(torch.from_numpy(a)
                                      for a in (x, shift, st)),
                            cfg=cfg, chunk=chunk)
    want = JR.time_mix_train(jt(tm), *(jnp.asarray(a)
                                       for a in (x, shift, st)),
                             cfg=jcfg, chunk=chunk)
    for g, w in zip(got, want):
        close(g, w, TOL)
    # the module runs the same function
    mod = PR.TimeMix(cfg, pt(tm))
    for g, m in zip(got, mod(*(torch.from_numpy(a) for a in (x, shift, st)),
                             chunk=chunk)):
        assert torch.equal(g, m)


def test_time_mix_decode_and_chunk_assertion():
    cfg, tm, _ = layer_params(3)
    jcfg = jget_reduced(ARCH)
    x, shift = activations(9, 2, 1, cfg.d_model)
    h, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    st = np.random.default_rng(6).standard_normal(
        (2, h, hs, hs)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, shift, st)]
    got = PR.time_mix_decode(pt(tm), *args, cfg=cfg)
    want = JR.time_mix_decode(jt(tm), *(jnp.asarray(a)
                                        for a in (x, shift, st)), cfg=jcfg)
    for g, w in zip(got, want):
        close(g, w, TOL)
    for g, m in zip(got, PR.TimeMix(cfg, pt(tm)).decode(*args)):
        assert torch.equal(g, m)
    # both routes take the inputs the reference takes: s % min(chunk, s)
    x3 = torch.from_numpy(activations(9, 2, 24, cfg.d_model)[0])
    with pytest.raises(AssertionError):
        PR.time_mix_train(pt(tm), x3, args[1], args[2], cfg=cfg, chunk=16)


def test_channel_mix():
    cfg, _, cm = layer_params(4)
    jcfg = jget_reduced(ARCH)
    x, shift = activations(10, 2, 8, cfg.d_model)
    got = PR.channel_mix(pt(cm), torch.from_numpy(x), torch.from_numpy(shift),
                         cfg=cfg)
    want = JR.channel_mix(jt(cm), jnp.asarray(x), jnp.asarray(shift),
                          cfg=jcfg)
    for g, w in zip(got, want):
        close(g, w, TOL)
    mod = PR.ChannelMix(cfg, pt(cm))
    for g, m in zip(got, mod(torch.from_numpy(x), torch.from_numpy(shift))):
        assert torch.equal(g, m)


# ---------------------------------------------------------------------------
# the kernel's plain versions against the Pallas kernel and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,hs,chunk", [(64, 32, 32), (128, 64, 64),
                                        (128, 32, 16)])
def test_wkv6_plain_matches_pallas_and_stepwise(s, hs, chunk):
    """tests/test_kernels.py::test_wkv6_kernel_sweep's shapes, zero
    initial state (the Pallas kernel's contract)."""
    r, k, v, w, u, zero = wkv_inputs(s, 2, s, 2, hs, state=False)
    ja, pa = both((r, k, v, w, u, zero))
    pallas_o, pallas_s = wkv6_pallas(*ja[:5], chunk=chunk)
    ref_o, ref_s = jwkv_stepwise(*ja)
    before = K.wkv6.launches
    for got_o, got_s in (K.wkv6(*pa, chunk=chunk),
                         K.wkv6_plain(*pa, chunk=chunk),
                         wkv_ref_stepwise(*pa)):
        for want_o, want_s in ((pallas_o, pallas_s), (ref_o, ref_s)):
            close(got_o, want_o, KTOL)
            close(got_s, want_s, KTOL)
    # on CPU tensors the wrapper runs the plain version: no launch
    assert K.wkv6.launches == before
    assert torch.equal(K.wkv6(*pa, chunk=chunk)[0],
                       K.wkv6_plain(*pa, chunk=chunk)[0])


@pytest.mark.parametrize("hs", [16, 64])
def test_stepwise_matches_jax_from_any_state(hs):
    arrays = wkv_inputs(hs, 2, 32, 2, hs)
    ja, pa = both(arrays)
    for g, w in zip(wkv_ref_stepwise(*pa), jwkv_stepwise(*ja)):
        close(g, w, KTOL)
    for g, w in zip(K.wkv6_plain(*pa, chunk=16), jwkv_stepwise(*ja)):
        close(g, w, KTOL)


def test_wrapper_refuses_other_devices():
    pa = both(wkv_inputs(0, 1, 4, 1, 16))[1]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.wkv6(*(a.to("meta") for a in pa))
