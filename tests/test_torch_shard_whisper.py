"""Whisper under the model axis of the port's sharded train step
(``make_train_step(cfg, opt_cfg, ctx)`` with a ('data', 'model') mesh of
the CPU; ``whisper.encode`` and ``decoder_train`` over a data position's
``lm.ModelGroup``):

  · reduced whisper-base (4 heads of 16, d_model 64, d_ff 128) on (1, 2)
    and (2, 2), the heads split, and on (1, 8), head_dim split into
    columns of 2: 3 steps against the port's unsharded step, loss and ce
    within 1e-5 relative, grad_norm 1e-4, every step's gradients and
    the parameters after the steps within 1e-4 of each leaf's largest;
  · K3' calls per position: the encoder's non-causal self attention over
    its 1,500 frames, the decoder's causal self attention and its cross
    attention over the frames, each on a position's heads (head split)
    or once on whole heads per data position (head_dim split);
  · the tied head: the embedding's d_model blocks joined into the whole
    table, exactly, and the decoder's tokens embedded from them;
  · the same bits with the model positions on two devices (two names of
    the CPU) as on one;
  · against the JAX package's own sharded step under ``make_ctx`` of a
    (2, 2) host mesh (4 forced host devices, in a subprocess), 2 steps;
  · a checkpoint of a model-split Whisper state is the unsharded state's
    file, byte for byte.
"""
from collections import Counter

import pytest
import torch

from repro_torch.checkpointing.checkpoint import save
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_to_torch
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch.mesh import make_ctx, make_train_mesh
from repro_torch.models import factory, lm
from repro_torch.models.layers import attention as attn_mod
from repro_torch.parallelism import sharding as shd
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig
from test_torch_shard_train import (DATA_SEED, KW, PARAM_TOL, SHAPE,
                                    assert_rows_close,
                                    check_against_reference, cpu_ctx,
                                    leaf_err, params_of, run, weights,
                                    whole_grads)

ARCH = "whisper-base"
MESHES = [(1, 2), (2, 2), (1, 8)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PLAIN = {}


def plain_run():
    """The port's unsharded 3 steps and each step's gradients, once."""
    if not _PLAIN:
        cfg = get_reduced(ARCH)
        grads = []
        real = TS._grads

        def record(model, batch, cfg_):
            out = real(model, batch, cfg_)
            grads.append({n: g.detach().clone() for n, g in out[2].items()})
            return out

        TS._grads = record
        try:
            rows, state = run(cfg, weights(cfg), None, SHAPE, 3)
        finally:
            TS._grads = real
        _PLAIN.update(rows=rows, params=params_of(state), grads=grads)
    return _PLAIN


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_step_matches_unsharded(monkeypatch, mesh):
    cfg = get_reduced(ARCH)
    want = plain_run()
    ctx = cpu_ctx(mesh)
    calls, grads = [], []
    real_fa, real_sg = attn_mod.flash_attention, TS._step_grads

    def counted(q, k, v, *, causal):
        calls.append((tuple(q.shape), k.shape[1], causal))
        return real_fa(q, k, v, causal=causal)

    def record(state, batch, cfg_, ctx_):
        metrics, g = real_sg(state, batch, cfg_, ctx_)
        grads.append({n: t.detach().clone()
                      for n, t in whole_grads(g, state).items()})
        return metrics, g

    monkeypatch.setattr(attn_mod, "flash_attention", counted)
    monkeypatch.setattr(TS, "_step_grads", record)
    rows, state = run(cfg, weights(cfg), ctx, SHAPE, 3)
    assert_rows_close(rows, want["rows"])
    for got_g, want_g in zip(grads, want["grads"]):
        err, leaf = leaf_err(got_g, want_g)
        assert err <= PARAM_TOL, (leaf, err)
    err, leaf = leaf_err(params_of(state), want["params"])
    assert err <= PARAM_TOL, (leaf, err)
    specs = {n: sh.spec for n, sh in state["placed"].items()}
    assert specs["embed.emb"] == (None, "model")
    assert specs["pos_dec"] == (None, None)
    # K3' calls, forward and recompute, of 3 steps: per encoder layer a
    # non-causal self attention over the frames, per decoder layer a
    # causal self attention and a non-causal cross attention over them,
    # each on every model position's heads or once on whole heads
    b, s = SHAPE.global_batch // ctx.dp_size, SHAPE.seq_len
    tp, h, hd = ctx.tp_size, cfg.n_heads, cfg.resolved_head_dim
    if h % tp == 0:
        reps, h_pos = ctx.dp_size * tp, h // tp
        assert specs["enc_blocks.0.attn.wq"] == (None, None, "model", None)
    else:
        reps, h_pos = ctx.dp_size, h
        assert specs["enc_blocks.0.attn.wq"] == (None, None, None, "model")
    n = 3 * 2 * reps
    assert Counter(calls) == Counter({
        ((b, 1500, h_pos, hd), 1500, False): n * cfg.n_enc_layers,
        ((b, s, h_pos, hd), s, True): n * cfg.n_layers,
        ((b, s, h_pos, hd), 1500, False): n * cfg.n_layers})


@pytest.mark.parametrize("mesh", [(1, 2), (1, 8)],
                         ids=lambda m: "x".join(map(str, m)))
def test_tied_head_joins_the_embedding_exactly(mesh):
    cfg = get_reduced(ARCH)
    ctx = cpu_ctx(mesh)
    model = factory.from_state_dict(cfg, lm_params_to_torch(
        weights(cfg), cfg, "cpu"))
    state = TS.init_train_state(model, cfg, OptConfig(**KW), ctx=ctx)
    blocks = shd.param_blocks(state["placed"])
    group = lm.ModelGroup(blocks[:ctx.tp_size],
                          list(ctx.mesh.devices.flat[:ctx.tp_size]))
    assert [bj["embed.emb"].shape[1] for bj in group.blocks] == \
        [cfg.d_model // ctx.tp_size] * ctx.tp_size
    assert group.d_model == cfg.d_model
    assert torch.equal(lm.head_weight(group, cfg), model.embed.emb.T)
    batch = to_device(make_batch_np(cfg, SHAPE, DATA_SEED, 0), "cpu")
    assert torch.equal(lm.embed_tokens(group, batch["tokens"]),
                       model.embed.emb[batch["tokens"].long()])


@pytest.mark.parametrize("mesh", [(1, 2), (1, 8)],
                         ids=lambda m: "x".join(map(str, m)))
def test_two_devices_give_the_same_bits(mesh):
    """The model positions alternating between two names of the CPU: 2
    steps give the same bits as every position on one device."""
    cfg = get_reduced(ARCH)
    devs = ["cpu", torch.device("cpu", 0)] * (mesh[1] // 2)
    want_rows, want = run(cfg, weights(cfg), cpu_ctx(mesh), SHAPE, 2)
    rows, state = run(cfg, weights(cfg), make_ctx(make_train_mesh(
        mesh, devices=devs)), SHAPE, 2)
    assert rows == want_rows
    got = TS.plain_state(state)["params"].state_dict()
    for n, t in params_of(want).items():
        assert torch.equal(got[n], t), n


def test_matches_the_reference_sharded_step_on_a_model_axis(tmp_path):
    check_against_reference(ARCH, (2, 2), tmp_path)


def test_model_split_checkpoint_is_the_unsharded_file(tmp_path):
    cfg = get_reduced(ARCH)
    _, state = run(cfg, weights(cfg), cpu_ctx((1, 8)), SHAPE, 2)
    assert state["placed"]["embed.emb"].spec == (None, "model")
    save(str(tmp_path / "sharded"), 2, state, cfg)
    plain = TS.plain_state(state)
    model = factory.from_state_dict(cfg, {
        k: v.detach().clone()
        for k, v in plain["params"].state_dict().items()})
    flat = TS.init_train_state(model, cfg, OptConfig(**KW))
    for k in ("m", "v"):
        for n, t in plain["opt"][k].items():
            flat["opt"][k][n].copy_(t)
    flat["step"] = 2
    save(str(tmp_path / "flat"), 2, flat, cfg)
    a, b = (open(tmp_path / d / "step-00000002.npz", "rb").read()
            for d in ("sharded", "flat"))
    assert a == b
