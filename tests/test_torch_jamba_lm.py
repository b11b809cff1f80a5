"""The port's jamba period (the ``period`` group kind: Mamba sublayers,
attention at index 4, MoE on every odd sublayer) against the JAX
package's, on the reduced jamba-v0.1-52b (one period of 8 sublayers,
d_model 64) with the same seeded weights (tests/_hybrid.py), mirroring
tests/test_models_smoke.py:

  · the group plan; ``init_cache`` leaves (``k``/``v``, ``h`` f32,
    ``conv``) equal in shape and dtype; the seeded tree has the leaf
    names and shapes of ``jax.eval_shape`` of the JAX ``init_params``;
  · prefill logits and cache, one decode step from the JAX package's own
    cache, and the greedy tokens: logits within rtol/atol 1e-4, tokens
    equal (top-2 margins above 1e-3 along the greedy path, asserted);
  · decode from the cache equals a teacher-forced prefill at
    ``capacity_factor=8.0``, where no token is dropped (2e-3);
  · ``train_loss`` within 1e-5 relative of the reference's, its balance
    loss too, every gradient leaf within 1e-4 of its largest magnitude;
  · checkpoints: the reference's restored by the port and the port's by
    the reference, leaf for leaf exact; the port's restart bit-identical;
  · the golden file's jamba entry is the JAX package's result and the
    port meets it; ``serve_decode`` and ``launch/train.py`` take jamba.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.factory as JF
import repro.models.lm as JL
from repro.checkpointing import checkpoint as JC
from repro.configs import get_reduced as jget_reduced
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.train_step import make_train_step as jmake_train_step
import repro_torch.models.factory as PF
from _hybrid import (BATCH, DATA_SEED, GRAD_TOL, LOSS_RTOL, MAX_LEN,
                     MIN_MARGIN, PROMPT_LEN, TRAIN_SHAPE, case, check_golden,
                     close, jax_grads, port_greedy, weights)
from repro_torch.checkpointing.checkpoint import restore, save
from repro_torch.configs import get_reduced
from repro_torch.convert import (lm_cache_to_numpy, lm_cache_to_torch,
                                 lm_params_to_numpy, lm_params_to_torch,
                                 seeded_lm_params, train_state_to_numpy)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch import serve_decode
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import LM, PeriodBlock, group_plan
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

ARCH = "jamba-v0.1-52b"
NO_DROP_CF = 8.0                 # tests/test_models_smoke.py's
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_group_plan_and_blocks():
    cfg = get_reduced(ARCH)
    assert group_plan(cfg) == JL.group_plan(jget_reduced(ARCH)) == [
        ("period", 1)]
    model = case(ARCH)[3]
    blk = model.groups[0][0]
    assert isinstance(blk, PeriodBlock)
    kinds = [("attn" if hasattr(s, "attn") else "mamba",
              "moe" if hasattr(s, "moe") else "mlp") for s in blk.children()]
    assert kinds == [(m, "moe" if i % 2 else "mlp")
                     for i, m in enumerate(cfg.block_pattern)]


def test_init_cache_layout():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda: JL.init_cache(jcfg, 3, 40))
    got = lm_cache_to_numpy(PF.init_cache(cfg, 3, 40, device="cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert w.shape == g.shape and w.dtype == g.dtype
        assert not g.any()
    assert got["groups"][0]["h"].dtype == np.float32


def test_seeded_tree_matches_jax_init():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    want = jax.eval_shape(lambda k: JF.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    got = weights(cfg)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, str(a.dtype)), t)
    assert shapes(got) == shapes(want)
    model = PF.init_params(0, cfg, device="cpu")
    sd = lm_params_to_torch(got, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert "groups.0.0.sub4.attn.wq" in sd and "groups.0.0.sub1.moe.wo" in sd
    # the port's leaves back in the reference's layout, exactly
    back = lm_params_to_numpy(sd, cfg)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(got)):
        assert np.array_equal(a, b), jax.tree_util.keystr(p)


def test_prefill_matches_jax():
    cfg, _, toks, model, ref = case(ARCH)
    logits, cache = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                               cfg=cfg, max_len=MAX_LEN)
    assert logits.shape == (BATCH, cfg.padded_vocab(32))
    close(logits, ref["prefill_logits"])
    got, want = lm_cache_to_numpy(cache), ref["cache"]
    assert np.array_equal(got["len"], want["len"])
    g, w = got["groups"][0], want["groups"][0]
    assert g.keys() == w.keys() == {"k", "v", "h", "conv"}
    for k in g:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
        close(g[k], w[k])
    assert not g["k"][:, :, PROMPT_LEN:].any()


def test_decode_step_matches_jax():
    """One decode step from the JAX package's own cache, carried across;
    the cache given is left unchanged."""
    cfg, _, _, model, ref = case(ARCH)
    cache = lm_cache_to_torch(ref["cache"], "cpu")
    tok = torch.from_numpy(ref["tokens"][:, :1].copy())
    logits, new = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    close(logits, ref["decode_logits"])
    assert new["len"].tolist() == [PROMPT_LEN + 1] * BATCH
    for name in ("k", "h", "conv"):
        assert np.array_equal(cache["groups"][0][name].numpy(),
                              ref["cache"]["groups"][0][name])
    assert new["groups"][0]["k"][:, :, PROMPT_LEN].abs().sum() > 0
    assert not torch.equal(new["groups"][0]["h"], cache["groups"][0]["h"])


def test_generate_matches_jax():
    cfg, _, toks, model, ref = case(ARCH)
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    got = PF.generate(model, cfg, torch.from_numpy(toks), max_new=6)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref["tokens"])
    assert np.array_equal(port_greedy(model, cfg, {
        "tokens": torch.from_numpy(toks)}).numpy(), ref["tokens"])


@pytest.mark.parametrize("s,steps", [(16, 1), (24, 8)])
def test_cache_consistency(s, steps):
    """decode-from-cache ≡ teacher-forced prefill at a capacity factor at
    which no token is dropped (tests/test_models_smoke.py's 8.0)."""
    cfg, _, toks, model, _ = case(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=NO_DROP_CF))
    t = torch.from_numpy(toks[:, :s].copy())
    full, _ = PF.prefill(model, {"tokens": t}, cfg=cfg)
    dec, cache = PF.prefill(model, {"tokens": t[:, :s - steps]}, cfg=cfg,
                            max_len=s)
    for i in range(s - steps, s):
        dec, cache = PF.decode(model, cache, {"tokens": t[:, i:i + 1]},
                               cfg=cfg)
    assert cache["len"].tolist() == [s] * BATCH
    assert float((full - dec).abs().max()) < 2e-3


def test_train_loss_and_grads_match_jax():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = weights(cfg)
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    jloss, jm, jgrads = jax_grads(tree, jcfg, batch)
    model = LM.from_state_dict(
        cfg, lm_params_to_torch(tree, cfg, "cpu")).requires_grad_(True)
    loss, metrics = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / jloss - 1) <= LOSS_RTOL
    assert float(jm["aux"]) > 0
    assert abs(metrics["aux"].item() / float(jm["aux"]) - 1) <= LOSS_RTOL
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads)}
    got = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(grads, cfg))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)


def _port_state(cfg, seed):
    model = LM.from_state_dict(
        cfg, lm_params_to_torch(seeded_lm_params(cfg, seed), cfg, "cpu"))
    return init_train_state(model, cfg, OptConfig(**KW))


def _leaves_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            jax.tree_util.keystr(path)


def test_checkpoints_cross_both_ways(tmp_path):
    """A reference step, its save, restored by the port: every leaf
    (parameters, moments, step) exact; then a port step, its save,
    restored by the reference: exact again."""
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    tree = seeded_lm_params(cfg, 0)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**KW)))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree),
              "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, tree)
                      for k in ("m", "v")},
              "step": jnp.zeros((), jnp.int32)}
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    JC.save(str(tmp_path / "ref"), 1, jstate)
    state = restore(str(tmp_path / "ref"), 1, _port_state(cfg, 1), cfg)
    assert state["step"] == 1
    _leaves_equal(train_state_to_numpy(state, cfg),
                  jax.tree_util.tree_map(np.asarray, jstate))
    state, _ = make_train_step(cfg, OptConfig(**KW))(
        state, to_device(make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 1),
                         "cpu"))
    save(str(tmp_path / "port"), 2, state, cfg)
    back = JC.restore(str(tmp_path / "port"), 2, jstate)
    _leaves_equal(jax.tree_util.tree_map(np.asarray, back),
                  train_state_to_numpy(state, cfg))


def test_restart_bit_identical(tmp_path):
    cfg = get_reduced(ARCH)
    step_fn = make_train_step(cfg, OptConfig(**KW))

    def run(state, start, n):
        for step in range(start, start + n):
            state, _ = step_fn(state, to_device(make_batch_np(
                cfg, TRAIN_SHAPE, 7, step), "cpu"))
        return state

    straight = run(_port_state(cfg, 0), 0, 4)
    first = run(_port_state(cfg, 0), 0, 2)
    save(str(tmp_path), 2, first, cfg)
    resumed = run(restore(str(tmp_path), 2, _port_state(cfg, 1), cfg), 2, 2)
    _leaves_equal(train_state_to_numpy(straight, cfg),
                  train_state_to_numpy(resumed, cfg))


def test_golden_on_cpu():
    check_golden(ARCH)


def test_serve_decode_cli_jamba(capsys):
    serve_decode.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"[{ARCH}] batch=2 prompt=8 new=3: ")


def test_train_launcher_jamba(capsys):
    train_launcher.main(["--arch", ARCH, "--steps", "2", "--batch", "2",
                         "--seq", "16", "--device", "cpu"])
    assert "[train] done: 2 steps, final loss" in capsys.readouterr().out
