"""The port's MLA (``repro_torch.models.layers.mla``) against the JAX
package's ``models/layers/mla.py``, on the reduced deepseek-v3-671b (q/k
head size 24, v head size 16) with the same numpy-seeded f32 weights and
inputs, rtol/atol 1e-5:

  · ``mla_train`` and its latent cache entries;
  · ``mla_decode`` (the absorbed form) from a seeded latent cache with a
    different length per row, the new caches included, and the caches it
    was given left unchanged;
  · decode after a prefill against a teacher-forced prefill (2e-5);
  · the port's plain ``chunked_attention`` with q/k and v of different
    head sizes, on its direct and its block-pair branch, against JAX's;
  · ``init_latent_cache``'s layout against ``init_cache``'s mla group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers.attention as JA
import repro.models.layers.mla as JMLA
from repro.configs import get_reduced as jget_reduced
from repro.parallelism.ctx import NULL_CTX
import repro_torch.models.layers.attention as PA
import repro_torch.models.layers.mla as PMLA
from repro_torch.configs import get_reduced

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 24


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


def setup(seed=0):
    """(port cfg, JAX cfg, weights with jittered norm scales, x)."""
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    p = PMLA.init_mla(numpy_draw(seed), cfg)
    rng = np.random.default_rng(seed + 50)
    for norm in ("q_norm", "kv_norm"):
        p[norm]["scale"] = p[norm]["scale"] + torch.from_numpy(
            0.1 * rng.standard_normal(p[norm]["scale"].shape,
                                      dtype=np.float32))
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return cfg, jcfg, p, x


def to_jax(p):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def positions(b, s, offset=0):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None] + offset,
                           (b, s)).copy()


def test_head_sizes_differ():
    m = get_reduced(ARCH).mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim != m.v_head_dim


def test_mla_train_matches_jax():
    cfg, jcfg, p, x = setup()
    pos = positions(B, S)
    out, (ckv, kr) = PMLA.mla_train(p, torch.from_numpy(x), cfg=cfg,
                                    positions=torch.from_numpy(pos),
                                    return_cache=True)
    jout, (jckv, jkr) = JMLA.mla_train(to_jax(p), jnp.asarray(x), cfg=jcfg,
                                       ctx=NULL_CTX,
                                       positions=jnp.asarray(pos),
                                       return_cache=True)
    assert out.shape == (B, S, cfg.d_model)
    close(out, jout)
    close(ckv, jckv)
    close(kr, jkr)
    plain = PMLA.mla_train(p, torch.from_numpy(x), cfg=cfg,
                           positions=torch.from_numpy(pos))
    assert torch.equal(plain, out)


def test_mla_train_longer_sequence_matches_jax():
    """64 tokens of other weights.  mla_train fixes the attention's direct
    threshold, so its block-pair branch (above 2,048 tokens) is held
    through chunked_attention below."""
    cfg, jcfg, p, _ = setup(1)
    x = np.random.default_rng(3).standard_normal((1, 64, cfg.d_model),
                                                 dtype=np.float32)
    pos = positions(1, 64)
    out = PMLA.mla_train(p, torch.from_numpy(x), cfg=cfg,
                         positions=torch.from_numpy(pos))
    jout = JMLA.mla_train(to_jax(p), jnp.asarray(x), cfg=jcfg, ctx=NULL_CTX,
                          positions=jnp.asarray(pos))
    close(out, jout)


def seeded_cache(cfg, smax, seed):
    m = cfg.mla
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((B, smax, m.kv_lora_rank), dtype=np.float32)
    kr = rng.standard_normal((B, smax, m.qk_rope_head_dim), dtype=np.float32)
    return ckv, kr


def test_mla_decode_matches_jax():
    cfg, jcfg, p, x = setup()
    smax = 32
    ckv, kr = seeded_cache(cfg, smax, 9)
    lens = np.array([5, 17], np.int32)
    xs = x[:, :1]
    t_ckv, t_kr = torch.from_numpy(ckv), torch.from_numpy(kr)
    out, nckv, nkr = PMLA.mla_decode(p, torch.from_numpy(xs), t_ckv, t_kr,
                                     cfg=cfg,
                                     cache_len=torch.from_numpy(lens))
    jout, jckv, jkr = JMLA.mla_decode(to_jax(p), jnp.asarray(xs),
                                      jnp.asarray(ckv), jnp.asarray(kr),
                                      cfg=jcfg, ctx=NULL_CTX,
                                      cache_len=jnp.asarray(lens))
    assert out.shape == (B, 1, cfg.d_model)
    close(out, jout)
    close(nckv, jckv)
    close(nkr, jkr)
    # the caches it was given are unchanged; the new ones differ at lens
    assert np.array_equal(t_ckv.numpy(), ckv)
    changed = (nckv.numpy() != ckv).any(-1)
    assert changed.tolist() == [[t == n for t in range(smax)]
                                for n in lens]


def test_decode_after_prefill_equals_teacher_forced_prefill():
    """The last position of a prefill of S tokens against a prefill of
    S - 1 tokens (its latents as the cache) and one absorbed decode
    step."""
    cfg, _, p, x = setup()
    pos = torch.from_numpy(positions(B, S))
    xt = torch.from_numpy(x)
    full = PMLA.mla_train(p, xt, cfg=cfg, positions=pos)
    _, (ckv, kr) = PMLA.mla_train(p, xt[:, :S - 1], cfg=cfg,
                                  positions=pos[:, :S - 1],
                                  return_cache=True)
    cache = PMLA.init_latent_cache(cfg, 1, B, S)
    cache["ckv"][0, :, :S - 1] = ckv
    cache["kr"][0, :, :S - 1] = kr
    out, _, _ = PMLA.mla_decode(p, xt[:, S - 1:], cache["ckv"][0],
                                cache["kr"][0], cfg=cfg,
                                cache_len=torch.full((B,), S - 1,
                                                     dtype=torch.int32))
    close(out[:, 0], full[:, -1].numpy(), dict(rtol=2e-5, atol=2e-5))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("branch", ["direct", "block_pair"])
def test_chunked_attention_with_v_head_size_apart(causal, branch):
    """q/k of head size 24 and v of 16, as MLA calls it: the direct branch
    (sequence under the threshold) and the block-pair scan (threshold 16,
    chunks of 16 over 64)."""
    rng = np.random.default_rng(11)
    s = 64
    q = rng.standard_normal((B, s, 4, 24), dtype=np.float32)
    k = rng.standard_normal((B, s, 4, 24), dtype=np.float32)
    v = rng.standard_normal((B, s, 4, 16), dtype=np.float32)
    kw = (dict(chunk_q=16, chunk_k=16, direct_threshold=16)
          if branch == "block_pair" else {})
    got = PA.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, **kw)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                **kw)
    assert got.shape == (B, s, 4, 16)
    close(got, want)


def test_init_latent_cache_layout():
    import repro.models.lm as JL
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda: JL.init_cache(jcfg, 3, 40))["groups"][0]
    got = PMLA.init_latent_cache(cfg, cfg.n_dense_prefix, 3, 40)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
