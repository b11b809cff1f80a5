"""The port's dense-model layers against the JAX package's, on the same
numpy-seeded f32 inputs and weights, rtol/atol 1e-5 (the same f32
arithmetic, summed in another order):

  · RoPE with block-local pairing and M-RoPE (``rope_frequencies``,
    ``apply_rope``, ``mrope_sections``, ``apply_mrope``,
    ``text_mrope_positions``);
  · the FFN's three activations (``swiglu``, ``gelu`` in its tanh form,
    ``relu2``), through ``init_ffn``'s layout;
  · ``attention_train`` with its KV entries, against JAX's
    ``attention_train`` (the direct path at these lengths) and against
    JAX's block-pair online-softmax scan (``chunked_attention`` with small
    chunks and ``direct_threshold``), for rope, M-RoPE, QKV bias and
    MHA/GQA configs;
  · the reference's plain ``direct_attention`` and ``chunked_attention``
    in the port against JAX's;
  · ``gqa_decode_attention`` and ``attention_decode`` (per-row cache
    lengths) against JAX's, and ``init_kv_cache``'s layout.

Zero-initialised leaves (the QKV biases) get seeded noise first, so that
their paths are exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.attention as JA
import repro.models.layers.ffn as JFFN
import repro.models.layers.rope as JROPE
from repro.configs import get_reduced as jget_reduced
from repro.parallelism.ctx import NULL_CTX
import repro_torch.models.layers.attention as PA
import repro_torch.models.layers.ffn as PFFN
import repro_torch.models.layers.rope as PROPE
from repro_torch.configs import get_reduced

TOL = dict(rtol=1e-5, atol=1e-5)
# (arch, what it adds): rope + GQA, QKV bias + GQA, M-RoPE + bias, MHA
ARCHS = ["minitron-8b", "qwen2-72b", "qwen2-vl-2b", "codeqwen1.5-7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want), **tol)


def numpy_draw(seed):
    rng = np.random.default_rng(seed)

    def draw(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(std))
    return draw, rng


def both(tree):
    """A dict of tensors and the same as jnp arrays."""
    return tree, {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def attention_params(arch, seed):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    draw, rng = numpy_draw(seed)
    p = PA.init_attention(draw, cfg)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = p[name] + draw(tuple(p[name].shape), 0.1)
    return cfg, jcfg, rng, *both(p)


def positions_for(cfg, b, s, offset=0):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None] + offset,
                          (b, s)).copy()
    if cfg.rope_mode == "mrope":
        pos = np.stack([pos, pos + 1, 2 * pos])   # three distinct streams
    return torch.from_numpy(pos), jnp.asarray(pos)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 128])
def test_rope_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd), dtype=np.float32)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    close(PROPE.rope_frequencies(hd, 1e6), JROPE.rope_frequencies(hd, 1e6))
    close(PROPE.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta=1e4),
          JROPE.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4))
    assert PROPE.mrope_sections(hd) == JROPE.mrope_sections(hd)
    pos3 = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    close(PROPE.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            theta=1e6),
          JROPE.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta=1e6))
    close(PROPE.text_mrope_positions(torch.from_numpy(pos)),
          JROPE.text_mrope_positions(jnp.asarray(pos)))


def test_rope_keeps_dtype_and_pairs_within_blocks():
    x = torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16)
    x[..., 0] = 1.0
    out = PROPE.apply_rope(x, torch.tensor([[3]], dtype=torch.int32),
                           theta=1e4)
    assert out.dtype == torch.bfloat16
    # element 0 rotates with its partner 4, and nothing else moves
    assert torch.count_nonzero(out[..., [1, 2, 3, 5, 6, 7]]) == 0
    assert float(out[..., 4].abs()) > 0.1


# ---------------------------------------------------------------------------
# ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_ffn_matches_jax(act):
    draw, rng = numpy_draw(7)
    p, jp = both(PFFN.init_ffn(draw, 24, 40, act))
    assert set(p) == set(jax_ffn_keys(act))
    x = rng.standard_normal((2, 5, 24), dtype=np.float32)
    close(PFFN.apply_ffn(p, torch.from_numpy(x), act=act),
          JFFN.apply_ffn(jp, jnp.asarray(x), act=act))


def jax_ffn_keys(act):
    import jax
    return JFFN.init_ffn(jax.random.PRNGKey(0), 24, 40, act, jnp.float32)


def test_ffn_rejects_unknown_activation():
    draw, _ = numpy_draw(0)
    p = PFFN.init_ffn(draw, 8, 16, "relu")
    with pytest.raises(ValueError, match="relu"):
        PFFN.apply_ffn(p, torch.zeros((1, 1, 8)), act="relu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_train_matches_jax(arch, causal):
    cfg, jcfg, rng, p, jp = attention_params(arch, 11)
    x = rng.standard_normal((2, 24, cfg.d_model), dtype=np.float32)
    pos, jpos = positions_for(cfg, 2, 24)
    out, (k, v) = PA.attention_train(p, torch.from_numpy(x), cfg=cfg,
                                     positions=pos, causal=causal,
                                     return_kv=True)
    jout, (jk, jv) = JA.attention_train(jp, jnp.asarray(x), cfg=jcfg,
                                        ctx=NULL_CTX, positions=jpos,
                                        causal=causal, return_kv=True)
    close(out, jout)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-vl-2b"])
def test_attention_train_matches_jax_block_pair_scan(arch):
    """The reference's long-sequence path: the causal block-pair scan with
    8-token chunks over 32 tokens (direct_threshold 8 forces it)."""
    cfg, jcfg, rng, p, jp = attention_params(arch, 12)
    x = rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    pos, jpos = positions_for(cfg, 2, 32)
    out = PA.attention_train(p, torch.from_numpy(x), cfg=cfg, positions=pos)
    jx = jnp.asarray(x)
    q = JA._rope(JA._project_q(jp, jx, jcfg, NULL_CTX), jpos, jcfg)
    k, v = JA._project_kv(jp, jx, jcfg, NULL_CTX)
    k = JA._rope(k, jpos, jcfg)
    hd = jcfg.resolved_head_dim
    o = JA.chunked_attention(
        q, JA.repeat_kv(k, jcfg.n_heads, NULL_CTX, hd),
        JA.repeat_kv(v, jcfg.n_heads, NULL_CTX, hd), causal=True,
        chunk_q=8, chunk_k=8, direct_threshold=8)
    close(out, jnp.einsum("bshk,hkd->bsd", o, jp["wo"]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(32, 32), (16, 48)])
def test_plain_core_attention_matches_jax(causal, sq, skv):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal((2, s, 4, 16), dtype=np.float32)
               for s in (sq, skv, skv))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    valid = rng.random((2, skv)) < 0.8
    valid[:, 0] = True
    close(PA.direct_attention(tq, tk, tv, causal=causal,
                              kv_valid=torch.from_numpy(valid)),
          JA.direct_attention(jq, jk, jv, causal=causal,
                              kv_valid=jnp.asarray(valid)))
    kw = dict(causal=causal, chunk_q=8, chunk_k=16, direct_threshold=8)
    close(PA.chunked_attention(tq, tk, tv, **kw),
          JA.chunked_attention(jq, jk, jv, **kw))
    # the q-only chunking of long queries over a short KV
    kw = dict(causal=False, chunk_q=8, direct_threshold=skv)
    close(PA.chunked_attention(tq, tk, tv, **kw),
          JA.chunked_attention(jq, jk, jv, **kw))


def test_repeat_kv_matches_jax():
    k = np.random.default_rng(0).standard_normal((2, 3, 2, 8),
                                                 dtype=np.float32)
    close(PA.repeat_kv(torch.from_numpy(k), 6),
          JA.repeat_kv(jnp.asarray(k), 6, NULL_CTX, 8))


def test_gqa_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 6, 16), dtype=np.float32)
    kc, vc = (rng.standard_normal((3, 20, 2, 16), dtype=np.float32)
              for _ in range(2))
    valid = np.arange(20)[None, :] <= np.array([[4], [19], [0]])
    close(PA.gqa_decode_attention(*(torch.from_numpy(a)
                                    for a in (q, kc, vc, valid))),
          JA.gqa_decode_attention(*(jnp.asarray(a)
                                    for a in (q, kc, vc, valid))))


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_matches_jax(arch):
    cfg, jcfg, rng, p, jp = attention_params(arch, 13)
    b, smax = 3, 20
    shape = (b, smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    kc0, vc0 = kc.copy(), vc.copy()
    lens = np.array([5, 19, 0], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    got = PA.attention_decode(p, torch.from_numpy(x), torch.from_numpy(kc),
                              torch.from_numpy(vc), cfg=cfg,
                              cache_len=torch.from_numpy(lens))
    want = JA.attention_decode(jp, jnp.asarray(x), jnp.asarray(kc),
                               jnp.asarray(vc), cfg=jcfg, ctx=NULL_CTX,
                               cache_len=jnp.asarray(lens))
    for g, w in zip(got, want):
        close(g, w)
    # the caches passed in (which share memory with kc, vc) are unchanged
    assert np.array_equal(kc, kc0) and np.array_equal(vc, vc0)


def test_init_kv_cache_layout():
    cfg, jcfg = get_reduced("minitron-8b"), jget_reduced("minitron-8b")
    got = PA.init_kv_cache(cfg, 3, 2, 17)
    want = JA.init_kv_cache(jcfg, 3, 2, 17, jnp.float32)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32 and not got[key].any()
