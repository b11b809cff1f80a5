"""The model axis of the port's sharded train step for the dense and RWKV
families (``make_train_step(cfg, opt_cfg, ctx)`` with a ('data',
'model') mesh whose model axis splits heads), on meshes of the CPU:

  · reduced qwen2-vl-2b, minitron-8b, codeqwen1.5-7b and rwkv6-1.6b, 3
    steps on meshes (1, 2) and (2, 2), and qwen2-vl-2b on (1, 3) (6 q /
    2 KV heads: the KV heads replicated and position 1's two query heads
    straddling both; its FFN and head replicated, since 3 divides neither
    256 nor 512), against the port's unsharded step from the same
    weights and batches: loss and ce within 1e-5 relative, grad_norm
    within 1e-4, the parameters and the gathered moments within 1e-4 of
    each leaf's largest magnitude;
  · minitron-8b's token batch on (2, 2): the embedding split over
    d_model, looked up block by block and joined exactly, and every
    leaf's gradient of one step against the unsharded gradient;
  · K3' (flash_attention) and K2 (wkv6) called once per model position
    on its heads, in the forward and in the checkpointed recompute;
  · the vocab-parallel ``chunked_cross_entropy`` against the whole-vocab
    form, with -1 labels and a label in every block;
  · ``row_sum``, ``col_cat`` and ``fan_out``: the order of the sums, in
    the forward and in the backward;
  · against the JAX package's own sharded step under ``make_ctx`` of a
    (2, 2) host mesh (4 forced host devices, in a subprocess): reduced
    qwen2-vl-2b and rwkv6-1.6b, 2 steps, within the limits above, each
    moment's blocks the shapes of the reference's shards;
  · a checkpoint of a model-split state is the unsharded state's file,
    byte for byte, and a restore then 3 steps equals 6 straight, bit for
    bit, on one repeated device and on two.
"""
import pytest
import torch

from repro_torch.checkpointing.checkpoint import restore, save
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (jitter_constant_leaves, lm_params_to_torch,
                                 seeded_lm_params)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models import factory, lm
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import rwkv6 as rwkv_mod
from repro_torch.models.loss import chunked_cross_entropy
from repro_torch.parallelism import sharding as shd
from repro_torch.parallelism.tensor import col_cat, fan_out, row_sum
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig
from test_torch_shard_train import (DATA_SEED, KW, PARAM_TOL, SHAPE,
                                    assert_rows_close,
                                    check_against_reference, cpu_ctx,
                                    leaf_err, params_of, plain_run, run,
                                    weights)

ARCHS = ["qwen2-vl-2b", "minitron-8b", "codeqwen1.5-7b", "rwkv6-1.6b"]
CASES = [(a, m) for a in ARCHS for m in ((1, 2), (2, 2))] + \
    [("qwen2-vl-2b", (1, 3))]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lm_state(cfg):
    """The seeded weights as the port's {name: tensor}."""
    return lm_params_to_torch(weights(cfg), cfg, "cpu")


@pytest.mark.parametrize("arch,mesh", CASES,
                         ids=[f"{a}-{'x'.join(map(str, m))}"
                              for a, m in CASES])
def test_tp_step_matches_unsharded(arch, mesh):
    cfg = get_reduced(arch)
    want_rows, want_params, want_opt = plain_run(arch)
    ctx = cpu_ctx(mesh)
    rows, state = run(cfg, weights(cfg), ctx, SHAPE, 3)
    assert state["step"] == 3
    # the model axis splits some parameters, and its storage is one copy
    specs = {n: sh.spec for n, sh in state["placed"].items()}
    assert any("model" in s for s in specs.values())
    assert all(list(sh.wholes) == [torch.device("cpu")]
               for sh in state["placed"].values())
    assert_rows_close(rows, want_rows)
    err, leaf = leaf_err(params_of(state), want_params)
    assert err <= PARAM_TOL, (leaf, err)
    plain = TS.plain_state(state)
    for k in ("m", "v"):
        err, leaf = leaf_err(plain["opt"][k], want_opt[k])
        assert err <= PARAM_TOL, (k, leaf, err)
    assert leaf_err(params_of(state), lm_state(cfg))[0] > 10 * PARAM_TOL


def test_straddling_heads_take_their_kv_heads():
    """qwen2-vl-2b reduced on a model axis of 3: KV heads replicated, the
    FFN and head too; position 1's query heads 2 and 3 read KV heads 0 and
    1, and its output partial equals those heads' share of the whole
    layer's output."""
    cfg = get_reduced("qwen2-vl-2b")
    ctx = cpu_ctx((1, 3))
    p = lm_state(cfg)
    specs = shd.param_pspecs(p, cfg, ctx)
    assert specs["groups.0.0.attn.wq"] == (None, None, "model", None)
    assert specs["groups.0.0.attn.wk"] == (None, None, None, None)
    assert specs["groups.0.0.mlp.wi_up"] == (None, None, None)
    assert specs["head.w"] == (None, None)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    pos = lm.make_positions(cfg, 2, 16)
    layer = {k.split(".")[-1]: v for k, v in p.items()
             if k.startswith("groups.0.0.attn.")}
    whole = attn_mod.attention_train(layer, x, cfg=cfg, positions=pos)
    parts = []
    for j in range(3):
        blk = dict(layer, wq=layer["wq"][:, 2 * j:2 * j + 2],
                   bq=layer["bq"][2 * j:2 * j + 2],
                   wo=layer["wo"][2 * j:2 * j + 2])
        parts.append(attn_mod.attention_heads(blk, x, cfg=cfg, positions=pos,
                                              head0=2 * j))
    got = row_sum(parts, [torch.device("cpu")] * 3)[0]
    assert float((got - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())


def test_token_embedding_split_over_d_model():
    """minitron-8b's token batch on (2, 2): each model position looks up
    its d_model columns of ``emb`` and ``col_cat`` joins them exactly; one
    step's gradient of every leaf against the unsharded one."""
    cfg = get_reduced("minitron-8b")
    ctx = cpu_ctx((2, 2))
    model = factory.from_state_dict(cfg, lm_state(cfg))
    state = TS.init_train_state(model, cfg, OptConfig(**KW), ctx=ctx)
    assert state["placed"]["embed.emb"].spec == (None, "model")
    batch = to_device(make_batch_np(cfg, SHAPE, DATA_SEED, 0), "cpu")
    assert "tokens" in batch and "embeds" not in batch
    blocks = shd.param_blocks(state["placed"])
    group = lm.ModelGroup(blocks[:2], list(ctx.mesh.devices.flat[:2]))
    assert [b["embed.emb"].shape[1] for b in group.blocks] == \
        [cfg.d_model // 2] * 2
    got = lm.embed_tokens(group, batch["tokens"])
    assert torch.equal(got, model.embed.emb[batch["tokens"].long()])
    plain = factory.from_state_dict(cfg, lm_state(cfg)).requires_grad_(True)
    want = TS._grads(plain, batch, cfg)[2]
    _, grads = TS._step_grads(state, batch, cfg, ctx)
    err, leaf = leaf_err(grads, want)
    assert err <= PARAM_TOL, (leaf, err)
    assert float(grads["embed.emb"].abs().max()) > 0


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch,module,name,want", [
    ("qwen2-vl-2b", attn_mod, "flash_attention", (2, 32, 3, 16)),
    ("rwkv6-1.6b", rwkv_mod, "wkv6", (2, 32, 2, 16))])
def test_kernels_run_once_per_model_position(monkeypatch, arch, module,
                                             name, want):
    """On (2, 2) each data position's 2 rows go through each layer once
    per model position, on its half of the heads: forward and
    checkpointed recompute, 2 layers, 4 positions."""
    cfg = get_reduced(arch)
    calls = _counting(monkeypatch, module, name)
    run(cfg, weights(cfg), cpu_ctx((2, 2)), SHAPE, 1)
    assert calls == [want] * (2 * cfg.n_layers * 4)


@pytest.mark.parametrize("n_blocks", [2, 3, 4])
def test_vocab_parallel_cross_entropy(n_blocks):
    gen = torch.Generator().manual_seed(n_blocks)
    b, s, d, v = 3, 24, 8, 48
    hidden = torch.randn((b, s, d), generator=gen, requires_grad=True)
    w = torch.randn((d, v), generator=gen, requires_grad=True)
    labels = torch.randint(0, v, (b, s), generator=gen, dtype=torch.int32)
    labels[0, :5] = -1
    width = v // n_blocks
    for j in range(n_blocks):              # a label in every block
        labels[1, j] = j * width + width - 1
        labels[2, j] = j * width
    want = chunked_cross_entropy(hidden, w, labels, chunk=8)
    got = chunked_cross_entropy(
        hidden, [w[:, j * width:(j + 1) * width] for j in range(n_blocks)],
        labels, chunk=8)
    assert int(got[1]) == int(want[1]) == b * s - 5
    assert abs(float(got[0].detach() - want[0].detach())) <= \
        1e-6 * float(want[0].detach())
    gw = torch.autograd.grad(want[0], (hidden, w))
    gg = torch.autograd.grad(got[0], (hidden, w))
    for a, c in zip(gg, gw):
        assert float((a - c).abs().max()) <= 1e-6 * float(c.abs().max())


def test_row_sum_col_cat_and_fan_out():
    """row_sum adds in position order and col_cat joins in it, each
    result on every position's device; fan_out's backward adds the
    positions' gradients in position order, and skips an unused one."""
    cpu0 = torch.device("cpu", 0)
    devs = [torch.device("cpu"), cpu0, cpu0]
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((4, 5), generator=gen) * 10 ** i for i in range(3)]
    got = row_sum(xs, devs)
    assert all(torch.equal(g, (xs[0] + xs[1]) + xs[2]) for g in got)
    cat = col_cat(xs, devs)
    assert all(torch.equal(c, torch.cat(xs, dim=-1)) for c in cat)
    x = torch.randn((4, 5), generator=gen, requires_grad=True)
    outs = fan_out(x, devs)
    assert all(torch.equal(o, x) for o in outs)
    (grad,) = torch.autograd.grad(
        [outs[0], outs[2]], x, [xs[1], xs[2]])
    assert torch.equal(grad, xs[1] + xs[2])
    (grad,) = torch.autograd.grad(outs, x, xs)
    assert torch.equal(grad, (xs[0] + xs[1]) + xs[2])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "rwkv6-1.6b"])
def test_matches_the_reference_sharded_step_on_a_model_axis(arch,
                                                             tmp_path):
    check_against_reference(arch, (2, 2), tmp_path)


@pytest.mark.parametrize("devices", [
    pytest.param(["cpu"] * 4, id="one-device"),
    pytest.param(["cpu", torch.device("cpu", 0)] * 2, id="two-devices")])
def test_model_split_checkpoint_is_the_unsharded_file_and_restarts(
        devices, tmp_path):
    arch = "codeqwen1.5-7b"
    cfg = get_reduced(arch)
    tree = weights(cfg)
    shape = ShapeSpec("t", 32, 2, "train")
    ctx = make_ctx(make_train_mesh((2, 2), devices=devices))
    _, straight = run(cfg, tree, ctx, shape, 6)
    _, state = run(cfg, tree, ctx, shape, 3)
    save(str(tmp_path / "sharded"), 3, state, cfg)
    # the same values in an unsharded state
    plain = TS.plain_state(state)
    model = factory.from_state_dict(cfg, {
        k: v.detach().clone()
        for k, v in plain["params"].state_dict().items()})
    flat = TS.init_train_state(model, cfg, OptConfig(**KW))
    for k in ("m", "v"):
        for n, t in plain["opt"][k].items():
            flat["opt"][k][n].copy_(t)
    flat["step"] = 3
    save(str(tmp_path / "flat"), 3, flat, cfg)
    a, b = (open(tmp_path / d / "step-00000003.npz", "rb").read()
            for d in ("sharded", "flat"))
    assert a == b
    # restore into other weights, sharded, and 3 more steps
    other = jitter_constant_leaves(seeded_lm_params(cfg, 9, max_seq=64), 2)
    _, fresh = run(cfg, other, ctx, shape, 0)
    restore(str(tmp_path / "sharded"), 3, fresh, cfg)
    assert fresh["step"] == 3
    _, resumed = run(cfg, other, ctx, shape, 3, start=3, state=fresh)
    want = TS.plain_state(straight)
    got = TS.plain_state(resumed)
    for k, v in want["params"].state_dict().items():
        assert torch.equal(got["params"].state_dict()[k], v), k
    for k in ("m", "v"):
        for n, t in got["opt"][k].items():
            assert torch.equal(t, want["opt"][k][n]), (k, n)
