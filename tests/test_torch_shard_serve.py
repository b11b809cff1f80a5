"""Serving and eval under a mesh (``factory.prefill``/``decode``/
``generate``/``init_cache`` and ``train_step.make_eval_step`` with a
``ctx``, models/sharded.py) on meshes of the CPU, the reduced configs,
the weights carried from ``seeded_lm_params`` with its constant leaves
jittered:

  · every cache layout of ``cache_pspecs`` against the unsharded port at
    equal MoE token groups: by KV heads (qwen2-vl-2b on (2, 2)), by
    head_dim (qwen2-vl-2b on (1, 8)), by sequence over the model axis
    (minitron-8b on (1, 4)) and over data × model (minitron-8b's one row
    on (2, 4)), MLA's latent by sequence (deepseek-v3-671b on (1, 4)),
    RWKV's S by heads (rwkv6-1.6b on (1, 2)) and with cut heads (on (1,
    8)), Mamba's h and conv by d_inner (jamba-v0.1-52b on (3, 2)) and
    Whisper's four caches (whisper-base on (2, 2)): prefill logits and
    the gathered cache within 1e-5 of their largest magnitude, after the
    prefill and after the decode steps (the sequence layouts' last slabs
    past every step's keys, merged without a NaN), greedy tokens equal,
    each
    layout's spec pinned and each stored block the shape of the
    reference's (``repro.parallelism.sharding.cache_pspecs`` of the JAX
    package's cache);
  · the MoE models against the JAX package's prefill and decode under a
    ctx of the same axis sizes with its hints dropped
    (test_torch_shard_moe.py's ``UnhintedCtx``), at its token groups:
    reduced arctic-480b on (2, 2) (G = 2) and deepseek-v3-671b on (1, 4);
  · ``eval_step`` on a sharded state gives the first train step's loss,
    ce and aux;
  · the greedy token across vocab blocks: a tie that straddles two
    blocks goes to the first index;
  · two names of the CPU as two devices give the same bits as one, each
    storing only its cache blocks;
  · ``ctx=NULL_CTX`` is the unsharded path, bit for bit;
  · every config serves (``generate``; Whisper ``prefill`` and
    ``decode``) and evaluates on (2, 2), tokens equal to the unsharded
    port's at equal G.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
from repro.configs import get_reduced as jget_reduced
from repro.parallelism import sharding as jshd
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import lm_params_to_torch
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models import factory, sharded
from repro_torch.models.layers.moe import moe_groups
from repro_torch.parallelism import sharding as shd
from repro_torch.parallelism.ctx import NULL_CTX
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig
from test_torch_shard_moe import FakeMesh, UnhintedCtx
from test_torch_shard_train import DATA_SEED, KW, weights

TOL = 1e-5                      # of the largest magnitude
EVAL_RTOL = 1e-6
N_NEW = 4
FRAMES_SEED = 9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_of(cfg):
    return factory.from_state_dict(cfg, lm_params_to_torch(weights(cfg), cfg,
                                                           "cpu"))


def prompts_of(cfg, b, s):
    gen = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, dtype=torch.int32)}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(np.random.default_rng(
            FRAMES_SEED).standard_normal((b, 1500, cfg.d_model),
                                         dtype=np.float32))
    return batch


def err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def run(model, cfg, batch, n_new, ctx=NULL_CTX, dp=1, max_len=None):
    """(prefill logits, the cache after the prefill, the cache after the
    decode steps, greedy tokens (B, n_new), the last cache as it is),
    gathered on the CPU, the caches sized ``max_len`` (prompt + n_new by
    default); over a mesh ``model`` is placed first; unsharded the MoE
    layers take the token groups of ``dp`` data shards."""
    b, s = batch["tokens"].shape
    max_len = max_len or s + n_new

    def groups(n):
        return 1 if cfg.moe is None else moe_groups(dp, n, cfg.moe.top_k)

    if ctx.mesh is not None:
        model = factory.place_model(model, cfg, ctx)
        logits, cache = factory.prefill(model, batch, cfg=cfg,
                                        max_len=max_len, ctx=ctx)
        first = sharded.greedy(logits)
        whole = shd.gather(logits, "cpu")
        gathered = sharded.gather_cache(cache, "cpu")
    else:
        logits, cache = factory.prefill(model, batch, cfg=cfg,
                                        max_len=max_len,
                                        moe_groups=groups(b * s))
        first = torch.argmax(logits, -1).to(torch.int32)[:, None]
        whole, gathered = logits, cache
    toks = [first]
    for _ in range(n_new - 1):
        if ctx.mesh is not None:
            logits, cache = factory.decode(model, cache,
                                           {"tokens": toks[-1]}, cfg=cfg,
                                           ctx=ctx)
            toks.append(sharded.greedy(logits))
        else:
            logits, cache = factory.decode(model, cache,
                                           {"tokens": toks[-1]}, cfg=cfg,
                                           moe_groups=groups(b))
            toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    last = sharded.gather_cache(cache, "cpu") if ctx.mesh is not None \
        else cache
    return whole, gathered, last, torch.cat(toks, dim=1), cache


def leaves(tree) -> dict:
    return dict(sharded._leaves(tree))


def ref_block_shapes(arch, mesh, b, max_len) -> dict:
    """{path: the block shape} of the JAX package's cache under its
    ``cache_pspecs`` on a mesh of these axis sizes."""
    jcfg = jget_reduced(arch)
    ctx = UnhintedCtx(mesh=FakeMesh(dict(zip(("data", "model"), mesh))),
                      batch_axes=("data",), tp_axis="model")
    cache = jax.eval_shape(lambda: JF.init_cache(jcfg, b, max_len))
    specs = jshd.cache_pspecs(cache, jcfg, ctx)
    out = {}
    for (path, x), spec in zip(
            jax.tree_util.tree_leaves_with_path(cache),
            jax.tree_util.tree_leaves(specs, is_leaf=lambda t: isinstance(
                t, jax.sharding.PartitionSpec))):
        key = tuple(int(k.idx) if hasattr(k, "idx") else k.key
                    for k in path)
        shape = []
        for dim, entry in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            shape.append(dim // int(np.prod([mesh[("data", "model").index(
                a)] for a in axes] or [1])))
        out[key] = tuple(shape)
    return out


# (arch, mesh, batch, prompt, max_len, {leaf: the spec that pins the
# layout}); the sequence layouts' caches are longer than the prompt and
# the new tokens, so that their last slabs hold no key a step sees
LAYOUTS = {
    "kv-heads": ("qwen2-vl-2b", (2, 2), 4, 16, 20,
                 {"k": (None, "data", None, "model", None)}),
    "head-dim": ("qwen2-vl-2b", (1, 8), 4, 16, 20,
                 {"k": (None, "data", None, None, "model")}),
    "seq-model": ("minitron-8b", (1, 4), 4, 16, 32,
                  {"k": (None, "data", "model", None, None)}),
    "seq-data-model": ("minitron-8b", (2, 4), 1, 28, 48,
                       {"k": (None, None, ("data", "model"), None, None)}),
    "mla-latent": ("deepseek-v3-671b", (1, 4), 4, 16, 32,
                   {"ckv": (None, "data", "model", None)}),
    "rwkv-heads": ("rwkv6-1.6b", (1, 2), 4, 16, 20,
                   {"S": (None, "data", "model", None, None)}),
    "rwkv-cut-heads": ("rwkv6-1.6b", (1, 8), 4, 16, 20,
                       {"S": (None, "data", None, None, None)}),
    "mamba": ("jamba-v0.1-52b", (3, 2), 3, 16, 20,
              {"h": (None, None, "data", "model", None),
               "conv": (None, None, "data", None, "model")}),
    "whisper": ("whisper-base", (2, 2), 2, 8, 12,
                {"k": (None, "data", None, "model", None),
                 "ck": (None, "data", None, "model", None)}),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_cache_layouts_match_the_unsharded_port(case):
    arch, mesh, b, s, max_len, pinned = LAYOUTS[case]
    cfg = get_reduced(arch)
    model = model_of(cfg)
    batch = prompts_of(cfg, b, s)
    want = run(model, cfg, batch, N_NEW, dp=mesh[0], max_len=max_len)
    ctx = make_ctx(make_train_mesh(mesh, device="cpu"))
    got = run(model, cfg, batch, N_NEW, ctx=ctx, max_len=max_len)
    for t in (got[0], *leaves(got[2]).values()):
        assert bool(torch.isfinite(t.float()).all())
    assert err(got[0], want[0]) <= TOL
    for i in (1, 2):                       # after the prefill, at the end
        g, w = leaves(got[i]), leaves(want[i])
        assert set(g) == set(w)
        for path in w:
            assert g[path].shape == w[path].shape, path
            assert err(g[path], w[path]) <= TOL, (path, i)
    assert torch.equal(got[3], want[3]), (got[3], want[3])
    placed = leaves(got[4])
    for path, sh in placed.items():
        if path[-1] in pinned:
            assert sh.spec == pinned[path[-1]], (path, sh.spec)
    ref = ref_block_shapes(arch, mesh, b, max_len)
    assert set(ref) == set(placed)
    for path, sh in placed.items():
        assert all(t is not None and tuple(t.shape) == ref[path]
                   for t in sh.blocks), (path, ref[path])


def _jax_logits(arch, mesh, tree, batch, toks):
    """The JAX package's prefill logits and each decode step's, fed the
    tokens ``toks``, under an unhinted ctx of ``mesh``'s axis sizes."""
    jcfg = jget_reduced(arch)
    ctx = UnhintedCtx(mesh=FakeMesh(dict(zip(("data", "model"), mesh))),
                      batch_axes=("data",), tp_axis="model")
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    s = batch["tokens"].shape[1]
    pre = jax.jit(lambda p, t: JF.prefill(p, {"tokens": t}, cfg=jcfg,
                                          ctx=ctx, max_len=s + N_NEW))
    step = jax.jit(lambda p, c, t: JF.decode(p, c, {"tokens": t}, cfg=jcfg,
                                             ctx=ctx))
    logits, cache = pre(params, jnp.asarray(batch["tokens"].numpy()))
    out = [np.asarray(logits)]
    for i in range(toks.shape[1] - 1):
        logits, cache = step(params, cache, jnp.asarray(
            toks[:, i:i + 1].numpy()))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("arch,mesh", [("arctic-480b", (2, 2)),
                                       ("deepseek-v3-671b", (1, 4))],
                         ids=["arctic-2x2", "deepseek-1x4"])
def test_moe_serving_matches_the_reference_groups(arch, mesh):
    cfg = get_reduced(arch)
    tree = weights(cfg)
    model = factory.from_state_dict(cfg, lm_params_to_torch(tree, cfg,
                                                            "cpu"))
    batch = prompts_of(cfg, 4, 16)
    ctx = make_ctx(make_train_mesh(mesh, device="cpu"))
    pm = factory.place_model(model, cfg, ctx)
    logits, cache = factory.prefill(pm, batch, cfg=cfg, max_len=16 + N_NEW,
                                    ctx=ctx)
    got, toks = [shd.gather(logits, "cpu")], [sharded.greedy(logits)]
    for _ in range(N_NEW - 1):
        logits, cache = factory.decode(pm, cache, {"tokens": toks[-1]},
                                       cfg=cfg, ctx=ctx)
        got.append(shd.gather(logits, "cpu"))
        toks.append(sharded.greedy(logits))
    want = _jax_logits(arch, mesh, tree, batch, torch.cat(toks, dim=1))
    vocab = cfg.vocab_size
    for g, w in zip(got, want):
        assert err(g[:, :vocab], torch.tensor(w)[:, :vocab]) <= TOL


def test_eval_step_gives_the_first_train_steps_metrics():
    cfg = get_reduced("arctic-480b")
    ctx = make_ctx(make_train_mesh((2, 2), device="cpu"))
    opt = OptConfig(**KW)
    state = TS.init_train_state(model_of(cfg), cfg, opt, ctx=ctx)
    batch = to_device(make_batch_np(cfg, ShapeSpec("t", 16, 4, "train"),
                                    DATA_SEED, 0), "cpu")
    ev = TS.make_eval_step(cfg, ctx)(state, batch)
    _, m = TS.make_train_step(cfg, opt, ctx)(state, batch)
    for k in ("loss", "ce", "aux"):
        assert abs(float(ev[k]) - float(m[k])) <= EVAL_RTOL * abs(
            float(m[k])), (k, float(ev[k]), float(m[k]))
    assert float(m["aux"]) > 0


def test_greedy_takes_the_first_index_across_vocab_blocks():
    """A head whose only non-zero columns are the last of the first vocab
    block and the first of the second, both the same one-hot column at a
    hidden coordinate that is positive in every row: those two logits
    are exactly equal and the largest; the token is the first."""
    cfg = get_reduced("qwen2-vl-2b")
    ctx = make_ctx(make_train_mesh((1, 2), device="cpu"))
    batch = prompts_of(cfg, 2, 8)
    vp, d = cfg.padded_vocab(32), cfg.d_model
    c1 = vp // 2 - 1
    model = model_of(cfg)
    with torch.no_grad():
        model.head.w.zero_()
        model.head.w[:, :d] = torch.eye(d)         # logits[:d] = hidden
    hidden, _ = factory.prefill(model, batch, cfg=cfg)
    i = int(torch.nonzero((hidden[:, :d] > 0).all(0))[0])
    with torch.no_grad():
        model.head.w.zero_()
        model.head.w[i, c1:c1 + 2] = 1.0
    pm = factory.place_model(model, cfg, ctx)
    logits, _ = factory.prefill(pm, batch, cfg=cfg, ctx=ctx)
    blocks = dict(shd.regions(logits))
    assert len(blocks) == 2
    whole = shd.gather(logits, "cpu")
    assert torch.equal(whole[:, c1], whole[:, c1 + 1])
    assert bool((whole[:, c1] > 0).all())
    assert sharded.greedy(logits).flatten().tolist() == [c1, c1]
    # and the later block wins where its max is larger
    with torch.no_grad():
        model.head.w[i, c1 + 1] = 2.0
    pm = factory.place_model(model, cfg, ctx)
    logits, _ = factory.prefill(pm, batch, cfg=cfg, ctx=ctx)
    assert sharded.greedy(logits).flatten().tolist() == [c1 + 1, c1 + 1]


def test_two_cpu_devices_give_the_same_bits_and_hold_their_blocks():
    cfg = get_reduced("qwen2-vl-2b")
    batch = prompts_of(cfg, 2, 16)
    one = run(model_of(cfg), cfg, batch, N_NEW,
              ctx=make_ctx(make_train_mesh((1, 2), device="cpu")))
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    ctx = make_ctx(make_train_mesh((1, 2), devices=devs))
    two = run(model_of(cfg), cfg, batch, N_NEW, ctx=ctx)
    assert torch.equal(one[0], two[0])
    assert torch.equal(one[3], two[3])
    for i in (1, 2):
        for path, t in leaves(one[i]).items():
            assert torch.equal(t, leaves(two[i])[path]), path
    for path, sh in leaves(two[4]).items():
        for dev, items in sh.stores.items():
            mine = [sh.where[p] for p, d in enumerate(sh.devices)
                    if d == dev]
            assert [b for b, _ in items] == list(dict.fromkeys(mine)), path
            if path[-1] in ("k", "v"):       # split by KV heads
                assert dev not in sh.wholes and len(items) == 1


def test_null_ctx_is_the_unsharded_path():
    cfg = get_reduced("arctic-480b")
    model = model_of(cfg)
    prompts = prompts_of(cfg, 2, 8)["tokens"]
    a = factory.generate(model, cfg, prompts, max_new=N_NEW)
    b = factory.generate(model, cfg, prompts, max_new=N_NEW, ctx=NULL_CTX)
    assert torch.equal(a, b)
    la, ca = factory.prefill(model, {"tokens": prompts}, cfg=cfg)
    lb, cb = factory.prefill(model, {"tokens": prompts}, cfg=cfg,
                             ctx=NULL_CTX)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, leaves(cb)[p]) for p, x in leaves(ca).items())


ALL_ARCHS = ["arctic-480b", "codeqwen1.5-7b", "deepseek-v3-671b",
             "jamba-v0.1-52b", "minitron-8b", "phi3-medium-14b",
             "qwen2-72b", "qwen2-vl-2b", "rwkv6-1.6b", "whisper-base"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_serves_and_evaluates_on_2x2(arch):
    cfg = get_reduced(arch)
    ctx = make_ctx(make_train_mesh((2, 2), device="cpu"))
    b, s = 4, 16
    model = model_of(cfg)
    if cfg.enc_dec:
        batch = prompts_of(cfg, 2, 8)
        want = run(model, cfg, batch, N_NEW, dp=2)[3]
        got = run(model, cfg, batch, N_NEW, ctx=ctx)[3]
    else:
        batch = prompts_of(cfg, b, s)
        want = run(model, cfg, batch, N_NEW, dp=2)[3]
        got = factory.generate(factory.place_model(model, cfg, ctx), cfg,
                               batch["tokens"], max_new=N_NEW, ctx=ctx)
    assert torch.equal(got, want), (got, want)
    data = to_device(make_batch_np(cfg, ShapeSpec("t", s, b, "train"),
                                   DATA_SEED, 0), "cpu")
    groups = 1 if cfg.moe is None else moe_groups(2, b * s, cfg.moe.top_k)
    with torch.no_grad():
        _, plain = factory.combine_parts([factory.loss_parts(
            model_of(cfg), data, cfg=cfg, moe_groups=groups)], cfg=cfg)
    state = TS.init_train_state(model_of(cfg), cfg, OptConfig(**KW), ctx=ctx)
    ev = TS.make_eval_step(cfg, ctx)(state, data)
    for k in ("loss", "ce", "aux"):
        assert abs(float(ev[k]) - float(plain[k])) <= 1e-5 * max(
            abs(float(plain[k])), 1e-30), (k, float(ev[k]), float(plain[k]))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b"])
def test_init_placed_draws_the_weights_of_init_params(arch):
    """``init_placed`` draws and places a model part by part (a block, a
    period's sublayer): the same bits as ``init_params``, placed as
    ``place_model`` places them."""
    cfg = get_reduced(arch)
    ctx = make_ctx(make_train_mesh((2, 2), device="cpu"))
    pm = factory.init_placed(0, cfg, ctx)
    model = factory.init_params(0, cfg, device="cpu")
    want = factory.place_model(model, cfg, ctx)
    assert list(pm.placed) == list(want.placed)
    for name, sh in pm.placed.items():
        assert sh.spec == want.placed[name].spec, name
        assert torch.equal(shd.gather(sh, "cpu"),
                           model.state_dict()[name]), name
