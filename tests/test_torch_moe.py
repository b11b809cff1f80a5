"""The port's MoE layer (``repro_torch.models.layers.moe``) against the JAX
package's ``models/layers/moe.py``, on the same numpy-seeded f32 weights
and inputs:

  · the layer's output and balance loss (``moe_layer`` and
    ``balance_loss``) against the reference's ``apply_moe`` on the reduced
    arctic-480b
    (4 experts top-2, dense residual FFN) and on a reduced config with a
    shared expert and top-8 of 16 experts, at capacity factors 1.25 (some
    tokens dropped, asserted) and 8.0 (none dropped), rtol/atol 1e-5;
  · the dispatch buffer equal to the reference's, element for element;
  · ``_capacity`` equal to the reference's on a grid of sizes;
  · ties: with a zero router every probability is equal, and the experts
    chosen are ``jax.lax.top_k``'s (the lower ids), where ``torch.topk``
    chooses others;
  · the gradients of output and loss (input, router, experts, FFNs) against
    ``jax.grad``, within 1e-4 of each leaf's largest magnitude."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.moe as JM
from repro.configs import get_reduced as jget_reduced
import repro_torch.models.layers.moe as PM
from repro_torch.configs import get_reduced

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4


def apply_moe(p, x, cfg):
    """The port's layer as the reference's ``apply_moe``: (y, aux)."""
    y, stats = PM.moe_layer(p, x, cfg=cfg)
    return y, PM.balance_loss(stats, x.shape[0] * x.shape[1],
                              cfg.moe.n_experts)
SHAPE = (2, 24)                        # batch, sequence: 48 tokens


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


def configs(case, cf):
    """(port cfg, JAX cfg) of a case at capacity factor cf: "arctic" (the
    reduced arctic-480b) or "shared8" (the reduced deepseek-v3-671b with
    16 experts, top-8 and one shared expert)."""
    if case == "arctic":
        pc, jc = get_reduced("arctic-480b"), jget_reduced("arctic-480b")
        over = dict(capacity_factor=cf)
    else:
        pc = get_reduced("deepseek-v3-671b")
        jc = jget_reduced("deepseek-v3-671b")
        over = dict(n_experts=16, top_k=8, n_shared_experts=1,
                    capacity_factor=cf)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                                **over))
                 for c in (pc, jc))


def setup(case, cf, seed=0):
    pc, jc = configs(case, cf)
    p = PM.init_moe(numpy_draw(seed), pc)
    rng = np.random.default_rng(seed + 100)
    # a direction common to every token skews the routing, so that at a
    # capacity factor of 1.25 some experts overflow
    x = (rng.standard_normal(SHAPE + (pc.d_model,), dtype=np.float32)
         + 2 * rng.standard_normal(pc.d_model, dtype=np.float32))
    return pc, jc, p, x


def to_jax(p):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def kept_share(cfg, p, x):
    """The share of (token, expert) entries that fit their expert."""
    t = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(t @ p["router"], -1)
    _, idx = PM.top_k_experts(probs, cfg.moe.top_k)
    cap = PM._capacity(t.shape[0], cfg.moe.top_k, cfg.moe.n_experts,
                       cfg.moe.capacity_factor)
    _, _, keep, _ = PM._dispatch(t, idx, cfg.moe.n_experts, cap)
    return float(keep.float().mean())


@pytest.mark.parametrize("case", ["arctic", "shared8"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_apply_moe_matches_jax(case, cf):
    pc, jc, p, x = setup(case, cf)
    share = kept_share(pc, p, x)
    assert (share < 1.0) if cf == 1.25 else (share == 1.0), share
    y, aux = apply_moe(p, torch.from_numpy(x), pc)
    jy, jaux = JM.apply_moe(to_jax(p), jnp.asarray(x), cfg=jc)
    assert y.shape == SHAPE + (pc.d_model,) and y.dtype == torch.float32
    close(y, jy)
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(aux, jaux, dict(rtol=1e-6, atol=0))


@pytest.mark.parametrize("case", ["arctic", "shared8"])
def test_dispatch_buffer_equals_jax(case):
    pc, _, p, x = setup(case, 1.25)
    m = pc.moe
    t = torch.from_numpy(x).reshape(-1, pc.d_model)
    _, idx = PM.top_k_experts(torch.softmax(t @ p["router"], -1), m.top_k)
    cap = PM._capacity(t.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    buf, slot, keep, order = PM._dispatch(t, idx, m.n_experts, cap)
    jbuf, jslot, jkeep, jorder = JM._dispatch_one_group(
        jnp.asarray(t.numpy()), jnp.asarray(idx.numpy().astype(np.int32)),
        m.n_experts, cap)
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    for got, want in ((slot, jslot), (keep, jkeep), (order, jorder)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["arctic", "shared8"])
def test_dispatch_buffer_with_empty_experts_equals_jax(case):
    """Every token routed to experts 0..k-1 (a tied router): those overflow
    and drop, the others (the last one included) get no token; the buffer
    still equals the reference's."""
    pc, _, _, x = setup(case, 1.25)
    m = pc.moe
    t = torch.from_numpy(x).reshape(-1, pc.d_model)
    idx = torch.arange(m.top_k).expand(t.shape[0], m.top_k).contiguous()
    cap = PM._capacity(t.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    buf, _, keep, _ = PM._dispatch(t, idx, m.n_experts, cap)
    jbuf, _, jkeep, _ = JM._dispatch_one_group(
        jnp.asarray(t.numpy()), jnp.asarray(idx.numpy().astype(np.int32)),
        m.n_experts, cap)
    assert not bool(keep.all()) and not buf[m.top_k:].any()
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))


def test_capacity_matches_jax():
    for n in (1, 7, 48, 512, 4096):
        for k, e in ((2, 4), (2, 128), (8, 16), (8, 256)):
            for cf in (1.0, 1.25, 8.0, 32.0, 64.0):
                assert PM._capacity(n, k, e, cf) == JM._capacity(n, k, e, cf)


@pytest.mark.parametrize("case", ["arctic", "shared8"])
def test_tied_router_takes_the_lower_experts(case):
    """A zero router gives every expert the same probability: the port
    routes as jax.lax.top_k does (experts 0..k-1), and the layer's output
    matches the reference's."""
    pc, jc, p, x = setup(case, 1.25)
    p["router"] = torch.zeros_like(p["router"])
    e, k = pc.moe.n_experts, pc.moe.top_k
    probs = torch.full((SHAPE[0] * SHAPE[1], e), 1.0 / e)
    _, idx = PM.top_k_experts(probs, k)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx == torch.arange(k)).all()
    y, aux = apply_moe(p, torch.from_numpy(x), pc)
    jy, jaux = JM.apply_moe(to_jax(p), jnp.asarray(x), cfg=jc)
    close(y, jy)
    close(aux, jaux, dict(rtol=1e-6, atol=0))


def test_torch_topk_breaks_ties_otherwise():
    """Why the router does not call torch.topk: on 64 equal
    probabilities it picks other experts than jax.lax.top_k."""
    probs = torch.full((64,), 1.0 / 64)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(jidx).tolist() == [0, 1]
    assert PM.top_k_experts(probs, 2)[1].tolist() == [0, 1]
    assert torch.topk(probs, 2).indices.tolist() != [0, 1]


@pytest.mark.parametrize("case", ["arctic", "shared8"])
def test_apply_moe_grads_match_jax(case):
    """Gradients of sum(y * r) + aux with respect to the input and every
    leaf, against jax.grad, at the dropping capacity factor."""
    pc, jc, p, x = setup(case, 1.25)
    r = np.random.default_rng(7).standard_normal(
        SHAPE + (pc.d_model,), dtype=np.float32)

    def jloss(jp, jx):
        y, aux = JM.apply_moe(jp, jx, cfg=jc)
        return jnp.sum(y * jnp.asarray(r)) + aux

    jgx, jgp = jax.grad(jloss, argnums=(1, 0))(to_jax(p), jnp.asarray(x))
    leaves = jax.tree_util.tree_map(
        lambda t: t.clone().requires_grad_(True), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = apply_moe(leaves, xt, pc)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    got = [("x", xt.grad)] + [
        (jax.tree_util.keystr(path), t.grad) for path, t in
        jax.tree_util.tree_leaves_with_path(leaves)]
    want = [("x", jgx)] + [
        (jax.tree_util.keystr(path), w) for path, w in
        jax.tree_util.tree_leaves_with_path(jgp)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)
