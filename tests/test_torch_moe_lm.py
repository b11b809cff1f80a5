"""The port's MoE family (``std:moe`` for arctic-480b; ``mla:dense`` and
``mla:moe`` for deepseek-v3-671b) against the JAX package's, on the
reduced configs with the same seeded weights
(``repro_torch.convert.seeded_lm_params``, the constant leaves jittered by
``jitter_constant_leaves``), mirroring tests/test_models_smoke.py:

  · ``init_cache`` leaves (``k``/``v`` for std, ``ckv``/``kr`` for mla)
    equal in shape and dtype; the seeded tree has the leaf names and
    shapes of ``jax.eval_shape`` of the JAX ``init_params``;
  · prefill logits and cache, one decode step from the JAX package's own
    cache, and ``generate`` tokens: logits within rtol/atol 1e-4, tokens
    equal (the top-2 logit margins along the greedy path are above 1e-3,
    asserted);
  · decode from the cache equals a teacher-forced prefill at
    ``capacity_factor=8.0``, where no token is dropped (2e-3);
  · ``train_loss`` within 1e-5 relative of the reference's, its balance
    loss too, and every gradient leaf within 1e-4 of its largest
    magnitude;
  · checkpoints: the reference's restored by the port and the port's by
    the reference, leaf for leaf exact; the port's restart bit-identical;
  · tests/golden/torch_port_moe_reduced.json, which the chip smoke checks
    on the card, is the JAX package's result and the port meets it;
  · ``serve_decode`` and ``launch/train.py`` take ``--arch`` of both.

Regenerate the golden file from the JAX package with
    PYTHONPATH=src python scripts/moe_golden.py
"""
import dataclasses
import functools
import json
import os

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
from repro_torch.checkpointing.checkpoint import restore, save
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.convert import (jitter_constant_leaves, lm_cache_to_numpy,
                                 lm_cache_to_torch, lm_params_to_numpy,
                                 lm_params_to_torch, params_fingerprint,
                                 seeded_lm_params, train_state_to_numpy)
from repro_torch.data.pipeline import make_batch_np, to_device
from repro_torch.launch import serve_decode
from repro_torch.launch import train as train_launcher
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_moe_reduced.json")
ARCHS = ["arctic-480b", "deepseek-v3-671b"]
WEIGHT_SEED, JITTER_SEED, PROMPT_SEED = 0, 1, 2
BATCH, PROMPT_LEN, MAX_NEW = 2, 24, 6
TOL = dict(rtol=1e-4, atol=1e-4)
MIN_MARGIN = 1e-3
NO_DROP_CF = 8.0                 # tests/test_models_smoke.py's
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
TRAIN_SHAPE = ShapeSpec("t", 32, 2, "train")
DATA_SEED = 3
KW = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(cfg):
    return jitter_constant_leaves(seeded_lm_params(cfg, WEIGHT_SEED),
                                  JITTER_SEED)


def prompt(cfg):
    rng = np.random.default_rng(PROMPT_SEED)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)


def top2_margin(logits) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


def jax_reference(tree, jcfg, toks):
    """Prefill logits and cache (max_len = prompt + MAX_NEW, as generate
    sizes it), the first decode step's logits, the greedy tokens and the
    least top-2 margin along the greedy path."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, cache = JF.prefill(params, {"tokens": jnp.asarray(toks)},
                               cfg=jcfg, max_len=PROMPT_LEN + MAX_NEW)
    step = jax.jit(lambda p, c, t: JF.decode(p, c, {"tokens": t}, cfg=jcfg))
    margins = [top2_margin(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out, step_cache, dec_logits = [tok], cache, None
    for i in range(MAX_NEW - 1):
        lg, step_cache = step(params, step_cache, tok)
        dec_logits = lg if i == 0 else dec_logits
        margins.append(top2_margin(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        out.append(tok)
    return {"prefill_logits": np.asarray(logits),
            "cache": jax.tree_util.tree_map(np.asarray, cache),
            "decode_logits": np.asarray(dec_logits),
            "tokens": np.asarray(jnp.concatenate(out, 1)),
            "min_margin": min(margins)}


@functools.cache
def case(arch):
    """(cfg, tree, prompt, port model, JAX reference), once per arch."""
    cfg = get_reduced(arch)
    tree, toks = weights(cfg), prompt(cfg)
    model = LM.from_state_dict(cfg, lm_params_to_torch(tree, cfg, "cpu"))
    return (cfg, tree, toks, model,
            jax_reference(tree, jget_reduced(arch), toks))


def close(got, want):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want), **TOL)


def cache_names(cfg):
    return {"ckv", "kr"} if cfg.mla is not None else {"k", "v"}


@pytest.mark.parametrize("arch", ARCHS)
def test_group_plan(arch):
    from repro_torch.models.lm import group_plan
    assert group_plan(get_reduced(arch)) == JL.group_plan(jget_reduced(arch))
    assert group_plan(get_reduced(arch))[-1][0].endswith(":moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    want = jax.eval_shape(lambda: JL.init_cache(jcfg, 3, 40))
    got = lm_cache_to_numpy(PF.init_cache(cfg, 3, 40, device="cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert w.shape == g.shape and w.dtype == g.dtype
        assert not g.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_tree_matches_jax_init(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
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
    # the layers of an MoE group stack to (n, E, d, f)
    moe = got["groups"][-1]["moe"]
    n = cfg.n_layers - cfg.n_dense_prefix
    assert moe["wi_gate"].shape == (n, cfg.moe.n_experts, cfg.d_model,
                                    cfg.moe.d_ff_expert)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    cfg, _, toks, model, ref = case(arch)
    logits, cache = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                               cfg=cfg, max_len=PROMPT_LEN + MAX_NEW)
    assert logits.shape == (BATCH, cfg.padded_vocab(32))
    close(logits, ref["prefill_logits"])
    got, want = lm_cache_to_numpy(cache), ref["cache"]
    assert np.array_equal(got["len"], want["len"])
    for g, w in zip(got["groups"], want["groups"]):
        assert g.keys() == w.keys() == cache_names(cfg)
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            close(g[k], w[k])
            assert not g[k][:, :, PROMPT_LEN:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """One decode step from the JAX package's own cache, carried across."""
    cfg, _, _, model, ref = case(arch)
    cache = lm_cache_to_torch(ref["cache"], "cpu")
    tok = torch.from_numpy(ref["tokens"][:, :1].copy())
    logits, new = PF.decode(model, cache, {"tokens": tok}, cfg=cfg)
    close(logits, ref["decode_logits"])
    assert new["len"].tolist() == [PROMPT_LEN + 1] * BATCH
    name = sorted(cache_names(cfg))[0]
    assert np.array_equal(cache["groups"][0][name].numpy(),
                          ref["cache"]["groups"][0][name])
    assert new["groups"][0][name][:, :, PROMPT_LEN].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    cfg, _, toks, model, ref = case(arch)
    assert ref["min_margin"] > MIN_MARGIN, ref["min_margin"]
    got = PF.generate(model, cfg, torch.from_numpy(toks), max_new=MAX_NEW)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,steps", [(16, 1), (24, 8)])
def test_cache_consistency(arch, s, steps):
    """decode-from-cache ≡ teacher-forced prefill at a capacity factor at
    which no token is dropped (tests/test_models_smoke.py's 8.0)."""
    cfg, _, toks, model, _ = case(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = weights(cfg)
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JF.train_loss(p, jax.tree_util.tree_map(jnp.asarray,
                                                          batch), cfg=jcfg),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    model = LM.from_state_dict(
        cfg, lm_params_to_torch(tree, cfg, "cpu")).requires_grad_(True)
    loss, metrics = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / float(jloss) - 1) <= LOSS_RTOL
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


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """Two reference steps, its save, restored by the port: every leaf
    (parameters, moments, step) exact; then a port step, its save,
    restored by the reference: exact again."""
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    tree = seeded_lm_params(cfg, 0)
    jstep = jax.jit(jmake_train_step(jcfg, JOptConfig(**KW)))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree),
              "opt": {k: jax.tree_util.tree_map(jnp.zeros_like, tree)
                      for k in ("m", "v")},
              "step": jnp.zeros((), jnp.int32)}
    for step in range(2):
        batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, step)
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    JC.save(str(tmp_path / "ref"), 2, jstate)
    state = restore(str(tmp_path / "ref"), 2, _port_state(cfg, 1), cfg)
    assert state["step"] == 2
    _leaves_equal(train_state_to_numpy(state, cfg),
                  jax.tree_util.tree_map(np.asarray, jstate))
    state, _ = make_train_step(cfg, OptConfig(**KW))(
        state, to_device(make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 2),
                         "cpu"))
    save(str(tmp_path / "port"), 3, state, cfg)
    back = JC.restore(str(tmp_path / "port"), 3, jstate)
    _leaves_equal(jax.tree_util.tree_map(np.asarray, back),
                  train_state_to_numpy(state, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_bit_identical(arch, tmp_path):
    cfg = get_reduced(arch)
    step_fn = make_train_step(cfg, OptConfig(**KW))

    def run(state, start, n):
        for step in range(start, start + n):
            state, _ = step_fn(state, to_device(make_batch_np(
                cfg, TRAIN_SHAPE, 7, step), "cpu"))
        return state

    straight = run(_port_state(cfg, 0), 0, 6)
    first = run(_port_state(cfg, 0), 0, 3)
    save(str(tmp_path), 3, first, cfg)
    resumed = run(restore(str(tmp_path), 3, _port_state(cfg, 1), cfg), 3, 3)
    _leaves_equal(train_state_to_numpy(straight, cfg),
                  train_state_to_numpy(resumed, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_on_cpu(arch):
    """The golden file the chip smoke holds the card to is the JAX
    package's result, and the port on the CPU meets it."""
    cfg, tree, toks, model, ref = case(arch)
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert (golden["weight_seed"], golden["jitter_seed"],
            golden["max_new"]) == (WEIGHT_SEED, JITTER_SEED, MAX_NEW)
    g = golden["archs"][arch]
    assert g["weights_sum"] == pytest.approx(params_fingerprint(tree),
                                             rel=1e-9)
    assert np.array_equal(np.asarray(golden["prompt"][arch], np.int32), toks)
    for key in ("prefill_logits", "decode_logits"):
        close(np.asarray(g[key], np.float32), ref[key])
    assert np.array_equal(np.asarray(g["tokens"]), ref["tokens"])
    logits, _ = PF.prefill(model, {"tokens": torch.from_numpy(toks)},
                           cfg=cfg, max_len=PROMPT_LEN + MAX_NEW)
    close(logits, np.asarray(g["prefill_logits"], np.float32))
    # the training loss of the golden's batch, as the card's phase y reads
    batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
    loss, _ = PF.train_loss(model, to_device(batch, "cpu"), cfg=cfg)
    assert abs(loss.item() / g["train_loss"] - 1) <= LOSS_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_cli_moe(arch, capsys):
    serve_decode.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"[{arch}] batch=2 prompt=8 new=3: ")
    assert len(json.loads(lines[1].split(":", 1)[1])) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_moe(arch, capsys):
    train_launcher.main(["--arch", arch, "--steps", "2", "--batch", "2",
                         "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done: 2 steps, final loss" in out


def regen(path=GOLDEN):
    """Write the golden file from the JAX package (scripts/moe_golden.py)."""
    golden = {"config": "reduced", "weight_seed": WEIGHT_SEED,
              "jitter_seed": JITTER_SEED, "max_new": MAX_NEW,
              "max_len": PROMPT_LEN + MAX_NEW, "data_seed": DATA_SEED,
              "train_shape": [TRAIN_SHAPE.global_batch, TRAIN_SHAPE.seq_len],
              "prompt": {}, "archs": {}}
    for arch in ARCHS:
        cfg, jcfg = get_reduced(arch), jget_reduced(arch)
        tree, toks = weights(cfg), prompt(cfg)
        ref = jax_reference(tree, jcfg, toks)
        assert ref["min_margin"] > MIN_MARGIN, (arch, ref["min_margin"])
        batch = make_batch_np(cfg, TRAIN_SHAPE, DATA_SEED, 0)
        jloss, _ = JF.train_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jax.tree_util.tree_map(jnp.asarray, batch),
                                 cfg=jcfg)
        golden["prompt"][arch] = toks.tolist()
        golden["archs"][arch] = {
            "weights_sum": params_fingerprint(tree),
            "min_top2_margin": ref["min_margin"],
            "prefill_logits": ref["prefill_logits"].tolist(),
            "decode_logits": ref["decode_logits"].tolist(),
            "tokens": ref["tokens"].tolist(),
            "train_loss": float(jloss)}
    with open(path, "w") as f:
        json.dump(golden, f)
    print(f"wrote {path}")
